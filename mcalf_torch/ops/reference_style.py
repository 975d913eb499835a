"""Reference-style likelihood formulation, for benchmarking only.

Port of :mod:`mcalf_tpu.ops.reference_style`: the computational pattern of
the original MC-ALF likelihood, re-expressed in plain PyTorch so that a
benchmark can measure, on the same card, what the fused kernel buys over a
straightforward translation:

* a Python loop over components, and inside it a loop over transitions,
  each evaluating the Voigt profile on a (B, P) tensor of the batch's rows
  and pixels (the reference's per-pixel scalar Voigt function, vmapped);
* the Voigt--Hjerting function as Algorithm 916's 27-term series with two
  direct exponentials per term (54 per element), without the production
  code's recurrence, and the asymptotic form where u^2 + a^2 >= 111;
* the LSF as a ``'same'`` convolution with the edge pixels reset, and the
  reference's ``nansum`` Gaussian likelihood.

One thing differs from the JAX original: the Doppler offset u of each
pixel is formed in float64 (then rounded to float32).  Formed in float32,
as the JAX original does, c (1+z)/lambda - c/lambda_0 cancels two numbers
of about 2e15 Hz, and u is off by up to 2e-3 at z = 3: the JAX original
then differs from its own package's likelihood by up to about 40 in
log L (2.7e-4 relative) on rows drawn in the flagship's prior box.  In
float64 the formulation gives the production likelihood's numbers.

It shares the port's special functions (``erfcx``, ``wofz_real_asym``) and
constants, and nothing of its kernels: it calls neither the fused
likelihood nor ``hjert``, so it is an independent implementation of the
same semantics.  Nothing on the fit's path calls it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mcalf_torch.models.forward import CCGS, TAU_CONST, AbsorptionModel
from mcalf_torch.ops.convolve import FWHM_TO_SIGMA
from mcalf_torch.ops.faddeeva import erfcx, wofz_real_asym

__all__ = ["make_reference_style_loglike"]

_AN = 0.5 * np.arange(1, 28)


def _hjert_naive(x, a):
    """Voigt--Hjerting H(x, a) with the reference's series structure:
    Algorithm 916 with two direct exponentials per term (54 per element)
    and the same switch to the asymptotic form at x^2 + a^2 = 111."""
    sel = x * x + a * a < 111.0
    xs = torch.where(sel, x, 0.0)
    ys = torch.where(sel, a, 1.0)
    xy = xs * ys
    exx = torch.exp(-xs * xs)
    y2 = ys * ys
    f = exx * (
        erfcx(ys) * torch.cos(2.0 * xy)
        + xs * torch.sin(xy) / math.pi * torch.sinc(xy / math.pi)
    )
    s1 = torch.zeros_like(x)
    s23 = torch.zeros_like(x)
    for n in range(27):
        denom = 1.0 / (float(_AN[n] ** 2) + y2)
        s1 = s1 + float(np.exp(-(_AN[n] ** 2))) * denom
        s23 = s23 + (
            torch.exp(-((float(_AN[n]) + xs) ** 2))
            + torch.exp(-((float(_AN[n]) - xs) ** 2))
        ) * denom
    near = f + ys / math.pi * (-torch.cos(2.0 * xy) * (exx * s1) + 0.5 * s23)
    return torch.where(sel, near, wofz_real_asym(x, a))


def make_reference_style_loglike(model: AbsorptionModel, device="cuda"):
    """A (B, ndim) physical-parameter -> (B,) log-likelihood function on
    ``device`` (the GPU unless the CPU is asked for), built the reference's
    way (loops over components and transitions, the naive series)."""
    f32 = torch.float32
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f32, device=dev)

    w_cm = torch.as_tensor(np.asarray(model.obj_wl, np.float64) / 1e8, device=dev)
    data = t(model.obj)
    noise = t(model.obj_noise)
    tab = model.transition_table()
    nl = model.numlines
    lines = [(float(tab["wrest"][j]), t(tab["f"][j]), t(tab["gamma"][j])) for j in range(nl)]
    fill = (float(model.linefill.wrest), t(model.linefill.f), t(model.linefill.gamma))

    startind, endind = model.startind, model.endind
    ncompmax, nfill = model.ncompmax, model.nfill
    freespecres, freecont = model.freespecres, model.freecont
    contval = float(model.contval[0])
    fixed_specres = float(model.specres[0]) if not freespecres else 0.0
    velstep = float(model.velstep)
    half = model.kernel_half_size()
    kernel_x = torch.arange(-half, half + 1, dtype=f32, device=dev)
    P = w_cm.shape[0]
    pix = torch.arange(P, device=dev)
    edge = (pix < half) | (pix >= P - half)
    ispec2 = 1.0 / noise**2

    def voigt_tau(N, z, b, wrest, f, gamma):
        # N, z, b: (B, 1) columns against the (P,) pixel axis
        cold = 10.0**N
        wrest_cm = wrest / 1e8
        dnu = (b * 1e5) / wrest_cm
        avoigt = gamma / (4 * math.pi * dnu)
        # the Doppler offset in float64 (see the module's docstring)
        uvoigt = (
            (CCGS / (w_cm / (z.double() + 1.0)) - CCGS / wrest_cm)
            / ((b.double() * 1e5) / wrest_cm)
        ).to(f32)
        return TAU_CONST * cold * f * _hjert_naive(uvoigt, avoigt) / dnu

    def loglike(p):
        p = torch.as_tensor(p, dtype=f32, device=dev)
        B = p.shape[0]
        specres = p[:, 0:1] if freespecres else fixed_specres
        if freecont:
            cont = p[:, 1:2] if freespecres else p[:, 0:1]
        else:
            cont = contval
        thisncomp = torch.floor(p[:, startind : startind + 1])
        tau = torch.zeros((B, P), dtype=f32, device=dev)
        for i in range(ncompmax):
            idx = 1 + 3 * i + startind
            N, z, b = p[:, idx : idx + 1], p[:, idx + 1 : idx + 2], p[:, idx + 2 : idx + 3]
            ctau = torch.zeros((B, P), dtype=f32, device=dev)
            for wrest, f, gamma in lines:
                ctau = ctau + voigt_tau(N, z, b, wrest, f, gamma)
            tau = tau + torch.where(i < thisncomp, ctau, 0.0)
        for i in range(nfill):
            idx = 3 * i + endind
            tau = tau + voigt_tau(p[:, idx : idx + 1], p[:, idx + 1 : idx + 2],
                                  p[:, idx + 2 : idx + 3], *fill)
        spec = torch.exp(-tau)

        sigma = torch.as_tensor((specres / FWHM_TO_SIGMA) / velstep, dtype=f32, device=dev)
        kern = torch.exp(-(kernel_x**2) / (2 * sigma**2))
        kern = (kern / torch.sum(kern, dim=-1, keepdim=True)).expand(B, -1)
        # 'same' convolution (the kernel is symmetric), the edges reset
        windows = F.pad(spec, (half, half)).unfold(-1, 2 * half + 1, 1)   # (B, P, K)
        conv = torch.sum(windows * kern[:, None, :], dim=-1)
        model_flux = torch.where(edge, spec, conv) * cont
        chi2 = ispec2 * (data - model_flux) ** 2
        return -0.5 * torch.nansum(chi2 - torch.log(ispec2) + math.log(2.0 * math.pi), dim=-1)

    return loglike
