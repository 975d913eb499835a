"""Batched torch forward model + likelihood (the device compute path).

Port of :mod:`mcalf_tpu.models.jax_model`.  The problem is split as in the
JAX package into *static structure* (:class:`StaticSpec`) and *constants*
(:func:`build_consts`, numpy, built in float64 on the host and cast to
float32).  :func:`consts_from_numpy` carries that dict onto a device, and
:class:`TorchForward` holds it as ``nn.Module`` buffers.

On a CUDA device the likelihood runs the fused kernel
(:func:`mcalf_torch.ops.voigt_cuda.fused_loglike`) and the model flux the
tau kernel (:func:`mcalf_torch.ops.voigt_cuda.voigt_tau`); on the CPU both
run their plain PyTorch versions.  :class:`StackedForward` holds several
problems' constants with a leading problem axis
(:func:`mcalf_torch.models.batched.stack_problems`) and evaluates rows of
any of them in one kernel launch (the fused kernel in ``'same_edge'``, the
tau kernel in ``'wrap'`` and ``'same'``), each row's constants picked by
its problem index.  Each transition takes the JAX package's
static choice of Voigt evaluation, as an int32 mode per transition
(:func:`line_modes`): windowed Harris, plain Harris, or the full
Algorithm-916/asymptotic ``hjert`` for a strongly damped line.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mcalf_torch.models.forward import CCGS, TAU_CONST, AbsorptionModel
from mcalf_torch.ops.convolve import FWHM_TO_SIGMA, gaussian_kernel, lsf_convolve
from mcalf_torch.ops.faddeeva import HARRIS_A_MAX, HJERT_WIN_TMIN
from mcalf_torch.ops.voigt_cuda import (
    MODE_HARRIS,
    MODE_HJERT,
    MODE_WINDOWED,
    _runs,
    check_supported,
    fused_loglike,
    voigt_tau,
)

__all__ = [
    "StaticSpec",
    "static_spec",
    "build_consts",
    "consts_from_numpy",
    "line_modes",
    "fused_args",
    "loglike_from_fused",
    "loglike_core",
    "loglike_cube_core",
    "reconstruct_core",
    "chi2_core",
    "row_consts",
    "TorchForward",
    "StackedForward",
    "make_torch_forward",
    "make_stacked_forward",
]


@dataclass(frozen=True)
class StaticSpec:
    """Static structure of a fit problem (shapes + flags), as
    :class:`mcalf_tpu.models.jax_model.StaticSpec` without the Pallas
    switches."""

    ndim: int
    npix: int
    ntrans: int
    startind: int
    freecont: bool
    freespecres: bool
    half: int
    conv_mode: str
    asymmlike: bool
    has_gpriors: bool
    #: per-transition flag: the prior bound on the damping a is below
    #: HARRIS_A_MAX, so the Harris expansion is accurate for every sample
    harris: tuple = ()
    #: per-transition wing threshold on u^2 (0.0 = plain Harris): u^2 >=
    #: win_tmin[t] takes hjert_wing, with amp_max * e^{-tmin} < 1e-8 in tau
    win_tmin: tuple = ()


def static_spec(
    model: AbsorptionModel, conv_mode: str = "same_edge", gpriors: bool = False
) -> StaticSpec:
    tab = model.transition_table()
    # Worst-case damping per transition over the prior: a is maximal at the
    # LOWER b bound (a = gamma lambda0 / (4 pi b)).
    b_lo_kms = model.bounds_lo[tab["pidx"] + 2]
    dnu_min = b_lo_kms * 1e5 * (1e8 / tab["wrest"])
    a_max = tab["gamma"] / (4.0 * np.pi * dnu_min)
    harris = a_max < HARRIS_A_MAX
    # Wing-window threshold per transition: the absolute tau error of the
    # dropped exponential, amp_max * e^{-tmin}, stays below 1e-8, with
    # amp_max the static prior bound on the tau amplitude; floored at
    # HJERT_WIN_TMIN.  Harris transitions only.
    n_max = model.bounds_hi[tab["pidx"]]
    amp_max = TAU_CONST * 10.0 ** n_max * tab["f"] / dnu_min
    tmin = np.maximum(HJERT_WIN_TMIN, np.log(np.maximum(amp_max, 1e-30) * 1e8))
    win_tmin = tuple(float(tm) if h else 0.0 for tm, h in zip(tmin, harris))
    return StaticSpec(
        ndim=model.ndim,
        npix=model.npix,
        ntrans=int(tab["pidx"].size),
        startind=model.startind,
        freecont=model.freecont,
        freespecres=model.freespecres,
        half=model.kernel_half_size(),
        conv_mode=conv_mode,
        asymmlike=bool(model.asymmlike),
        has_gpriors=bool(gpriors and model.gpriors is not None),
        harris=tuple(bool(v) for v in harris),
        win_tmin=win_tmin,
    )


def build_consts(model: AbsorptionModel, gpriors: bool = False) -> Dict[str, Any]:
    """Constant tables for one fit problem (numpy).  All host precomputation
    happens in float64, then casts to f32 -- a copy of
    :func:`mcalf_tpu.models.jax_model.build_consts`."""
    tab = model.transition_table()
    c: Dict[str, Any] = {}
    # c / lambda [Hz] precomputed on host: full precision in the static part.
    c["c_over_wave"] = (CCGS / (model.obj_wl / 1e8)).astype(np.float32)     # (P,)
    # Wing-window grid geometry: pixel index as an affine function of
    # log(c/lam), fit in f64 on host, plus the grid's max deviation from
    # that fit.  [log cw[0], alpha, dev].
    q = np.log(np.asarray(c["c_over_wave"], np.float64))
    P = q.size
    alpha = (q[0] - q[-1]) / max(P - 1, 1)
    if alpha > 0:
        p_pred = (q[0] - q) / alpha
        dev = float(np.max(np.abs(np.arange(P) - p_pred)))
    else:  # degenerate / non-monotone grid
        alpha, dev = 1.0, float(P)
    c["wingrid"] = np.array([q[0], alpha, dev], np.float32)
    c["data"] = model.obj.astype(np.float32)                                # (P,)
    c["valid"] = model.valid                                                # (P,)
    c["ivar"] = np.where(
        model.valid, 1.0 / np.where(model.valid, model.obj_noise, 1.0) ** 2, 0.0
    ).astype(np.float32)
    c["noise"] = np.where(model.valid, model.obj_noise, np.inf).astype(np.float32)
    # 1/noise with invalid pixels zeroed: multiplying residuals by this
    # excludes them from the asymmlike outlier counts (fused-kernel path).
    c["inv_noise"] = np.where(
        model.valid, 1.0 / np.where(model.valid, model.obj_noise, 1.0), 0.0
    ).astype(np.float32)

    # Per-transition tables.
    c["pidx"] = tab["pidx"]                                                 # (T,)
    c["comp_id"] = tab["comp_id"].astype(np.float32)
    c["is_fill"] = tab["is_fill"]
    c["nujk"] = (CCGS / (tab["wrest"] / 1e8)).astype(np.float32)
    c["inv_wrest_cm"] = (1e8 / tab["wrest"]).astype(np.float32)
    c["gamma"] = tab["gamma"].astype(np.float32)
    c["f"] = tab["f"].astype(np.float32)

    # High-precision redshift handling: a redshift stored in f32 quantizes
    # to ~2.4e-7 steps (~1e-5 posterior sigma_z / 40), turning the
    # likelihood into a STEP function of z whose plateaus/ties measurably
    # bias nested sampling (-1.65 +/- 0.10 nats on the 1-comp CIV fit vs a
    # quadrature truth anchor).  Instead the u-argument is assembled as
    #     u * dnu = D0 + dz * (c/lam),
    # with D0 = (1 + zmid) c/lam - nu0 precomputed per (transition, pixel)
    # in float64 on host (zmid = prior midpoint, static) and dz = z - zmid
    # carried at f32 resolution of the PRIOR WIDTH (eps * 0.02 ~ 2.4e-9 in
    # z) by deriving it directly from the unit cube (loglike_cube_core).
    # Residual u error ~ 1e-5 Doppler widths vs ~ 2e-3 for naive f32 z.
    wave_cm64 = np.asarray(model.obj_wl, np.float64) / 1e8
    cw64 = CCGS / wave_cm64                                                 # (P,)
    nu0 = CCGS / (np.asarray(tab["wrest"], np.float64) / 1e8)               # (T,)
    z_lo = np.asarray(model.bounds_lo, np.float64)[tab["pidx"] + 1]
    z_hi = np.asarray(model.bounds_hi, np.float64)[tab["pidx"] + 1]
    zmid = 0.5 * (z_lo + z_hi)
    c["d0"] = ((1.0 + zmid)[:, None] * cw64[None, :] - nu0[:, None]).astype(
        np.float32
    )                                                                       # (T, P)
    c["zmid"] = zmid.astype(np.float32)                                     # (T,)
    c["zspan"] = (z_hi - z_lo).astype(np.float32)                           # (T,)
    c["u_zidx"] = (tab["pidx"] + 1).astype(np.int32)                        # (T,)

    c["contval"] = np.float32(model.contval[0])
    # Reference JAX path uses specres[0] when fixed; the numpy path uses
    # max(specres).  Identical for the 1-element case.
    c["fixed_specres"] = np.float32(
        model.specres[0] if not model.freespecres else 0.0
    )
    c["velstep"] = np.float32(model.velstep)
    c["const_term"] = np.float32(
        np.sum(
            -np.log(1.0 / model.obj_noise[model.valid] ** 2) + np.log(2.0 * np.pi)
        )
    )
    c["cdf4"] = np.float32(model.gauss_cdf[1])
    c["cdf5"] = np.float32(model.gauss_cdf[2])
    c["grace"] = np.float32(model.gracenum)

    c["lo"] = model.bounds_lo.astype(np.float32)
    c["hi"] = model.bounds_hi.astype(np.float32)

    if gpriors and model.gpriors is not None:
        mu, sig = _parse_gpriors(model.gpriors, model.ndim)
        use = np.isfinite(sig)
        c["gp_mu"] = np.where(use, mu, 0.0).astype(np.float32)
        c["gp_isig2"] = np.where(use, 1.0 / sig**2, 0.0).astype(np.float32)
        c["gp_norm"] = np.float32(
            np.sum(np.where(use, np.log(2.0 * np.pi * sig**2), 0.0))
        )

    return c


def _parse_gpriors(gpriors, ndim: int):
    """Parse the reference's Gpriors format: a flat sequence of 2*ndim
    entries alternating (value, sigma), with 'none' marking unconstrained
    dimensions."""
    mu = np.zeros(ndim)
    sig = np.full(ndim, np.inf)
    g = list(gpriors)
    if len(g) != 2 * ndim:
        raise ValueError(f"Gpriors must have 2*ndim={2*ndim} entries, got {len(g)}")
    for i in range(ndim):
        v, srr = g[2 * i], g[2 * i + 1]
        if str(v).lower() != "none" and str(srr).lower() != "none":
            mu[i] = float(v)
            sig[i] = float(srr)
    return mu, sig


def consts_from_numpy(
    c: Mapping[str, Any], device: "torch.device | str"
) -> Dict[str, torch.Tensor]:
    """Carry a :func:`build_consts` dict (this package's or the JAX
    package's -- same keys, numpy values) onto ``device``: floats as
    float32, integer index tables as int64, masks as bool."""
    out = {}
    for k, v in c.items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            t = torch.as_tensor(a.copy(), dtype=torch.bool)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.as_tensor(a.astype(np.int64))
        else:
            t = torch.as_tensor(a.astype(np.float32))
        out[k] = t.to(device)
    return out


def line_modes(s: StaticSpec) -> tuple:
    """Per-transition Voigt evaluation, as the JAX package chooses it in
    ``reconstruct_core`` and ``_accum_tau``: windowed Harris where a wing
    threshold is set, plain Harris where the prior bounds the damping below
    HARRIS_A_MAX, the full ``hjert`` otherwise."""
    win = s.win_tmin or (0.0,) * s.ntrans
    return tuple(
        MODE_WINDOWED if tm > 0.0 else MODE_HARRIS if h else MODE_HJERT
        for tm, h in zip(win, s.harris)
    )


# ---------------------------------------------------------------------------
# Compute cores: (params, consts, static) -> tensors.
# ---------------------------------------------------------------------------

def _head(p, c, s: StaticSpec):
    specres = p[..., 0] if s.freespecres else c["fixed_specres"]
    if s.freecont:
        cont = p[..., 1] if s.freespecres else p[..., 0]
    else:
        cont = c["contval"]
    return specres, cont


def _line_tables(p, c, s: StaticSpec, dz):
    """Per-(sample, transition) dz, gain, damping a, Doppler width dnu."""
    nact = torch.floor(p[..., s.startind])
    pidx = c["pidx"]
    N = p[..., pidx]
    b = p[..., pidx + 2]
    if dz is None:
        dz = p[..., pidx + 1] - c["zmid"]
    dnu = b * 1e5 * c["inv_wrest_cm"]
    avoigt = c["gamma"] / (4.0 * math.pi * dnu)
    amp = TAU_CONST * torch.pow(10.0, N) * c["f"] / dnu
    active = ((c["comp_id"] < nact[..., None]) | c["is_fill"]).to(torch.float32)
    return dz, active * amp, avoigt, dnu


def reconstruct_core(p, c, s: StaticSpec, dz=None, prob=None):
    """Model flux (..., P) for physical parameters p (..., ndim): tau by
    :func:`voigt_tau` (the kernel on CUDA, its plain twin on the CPU), then
    exp, the LSF convolution in ``s.conv_mode`` and the continuum, which
    the JAX package leaves to XLA too.  ``dz``: optional high-precision
    z - zmid (see build_consts); recovered from p in f32 when None.
    ``prob``: see :func:`loglike_cube_core` (``c`` then holds
    :func:`row_consts`; p is (B, ndim) and each row takes its own
    problem's tables, LSF taps and continuum)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    specres, cont = _head(p, c, s)
    dz, gain, avoigt, dnu = _line_tables(p, c, s, dz)
    T = s.ntrans
    tau = voigt_tau(
        dz.reshape(-1, T).contiguous(),
        gain.reshape(-1, T).contiguous(),
        avoigt.reshape(-1, T).contiguous(),
        dnu.reshape(-1, T).contiguous(),
        c["d0"], c["c_over_wave"], c["tmin"], c["modes"], prob=prob,
    ).reshape(p.shape[:-1] + (s.npix,))
    flux_model = torch.exp(-tau)
    if s.half > 0:
        if "taps" in c:
            kernel = c["taps"]
        else:
            sigma_pix = (specres / FWHM_TO_SIGMA) / c["velstep"]
            kernel = gaussian_kernel(sigma_pix.to(torch.float32), s.half)
        flux_model = lsf_convolve(flux_model, kernel, mode=s.conv_mode)
    return flux_model * torch.as_tensor(cont)[..., None]


def fused_args(p, c, s: StaticSpec, dz=None, prob=None):
    """The positional arguments of :func:`fused_loglike` for physical
    parameters p (..., ndim), flattened to a (B, ...) batch.  With ``prob``
    (B,), ``c`` holds :func:`row_consts` (per-row constants beside the
    stacked tables the kernel indexes by problem)."""
    T = s.ntrans
    specres, cont = _head(p, c, s)
    dz, gain, avoigt, dnu = _line_tables(p, c, s, dz)
    if s.half > 0 and "taps" in c:
        kern = c["taps"]
    elif s.half > 0:
        sigma_pix = (specres / FWHM_TO_SIGMA) / c["velstep"]
        kern = gaussian_kernel(sigma_pix.to(torch.float32), s.half)
        kern = kern.reshape(-1, 2 * s.half + 1)
    else:
        kern = torch.ones((1, 1), dtype=torch.float32, device=p.device)
    cont = torch.as_tensor(cont, dtype=torch.float32).reshape(-1)
    return (
        dz.reshape(-1, T).contiguous(),
        gain.reshape(-1, T).contiguous(),
        avoigt.reshape(-1, T).contiguous(),
        dnu.reshape(-1, T).contiguous(),
        c["d0"], c["c_over_wave"], c["data"], c["ivar"], c["inv_noise"],
        kern.contiguous(), cont.contiguous(), c["tmin"], c["modes"],
    )


def loglike_from_fused(p, c, s: StaticSpec, chi2, n4, n5):
    """Log-likelihood (...) from the fused (B,) chi^2 and asymmlike counts."""
    batch = p.shape[:-1]
    ll = -0.5 * (chi2.reshape(batch) + c["const_term"])
    if s.asymmlike:
        bad = (n5.reshape(batch) > c["cdf5"] + c["grace"]) | (
            n4.reshape(batch) > c["cdf4"] + c["grace"]
        )
        ll = torch.where(bad, -math.inf, ll)
    if s.has_gpriors:
        d = p - c["gp_mu"]
        ll = ll - 0.5 * (torch.sum(d * d * c["gp_isig2"], dim=-1) + c["gp_norm"])
    return ll


def chi2_core(p, c, s: StaticSpec):
    m = reconstruct_core(p, c, s)
    r = c["data"] - m
    return torch.sum(c["ivar"] * r * r, dim=-1)


def loglike_core(p, c, s: StaticSpec, dz=None, prob=None):
    """With ``conv_mode='same_edge'``: tau -> exp -> LSF conv -> chi^2 (+
    asymmlike counts) in one :func:`fused_loglike` call, the kernel on CUDA
    and its plain twin on the CPU; only the Gaussian-prior term stays
    outside.  Any other mode goes through :func:`reconstruct_core` (one
    :func:`voigt_tau` launch on CUDA), as the JAX package's does.
    ``prob``: see :func:`loglike_cube_core`; every row reads its own
    problem's data, weights and constants."""
    p = torch.as_tensor(p, dtype=torch.float32)
    if s.conv_mode == "same_edge":
        chi2, n4, n5 = fused_loglike(
            *fused_args(p, c, s, dz=dz, prob=prob), half=s.half,
            asymm=s.asymmlike, prob=prob,
        )
        return loglike_from_fused(p, c, s, chi2, n4, n5)
    m = reconstruct_core(p, c, s, dz=dz, prob=prob)
    # a stacked batch reads each row's (P,) tables by its problem: an
    # elementwise op of a (Q, P) table with rows of any problems takes the
    # (B, P) gather (live for this call only) or a kernel of its own, and
    # the gather keeps every row's ops and bits its solo row's
    per = (lambda k: c[k]) if prob is None else (lambda k: c[k].index_select(0, prob))
    r = per("data") - m
    ll = -0.5 * (torch.sum(per("ivar") * r * r, dim=-1) + c["const_term"])
    if s.asymmlike:
        resid = r / per("noise")
        valid = per("valid")
        n5 = torch.sum((resid > 5.0) & valid, dim=-1)
        n4 = torch.sum((resid > 4.0) & valid, dim=-1)
        bad = (n5 > c["cdf5"] + c["grace"]) | (n4 > c["cdf4"] + c["grace"])
        ll = torch.where(bad, -math.inf, ll)
    if s.has_gpriors:
        d = p - c["gp_mu"]
        ll = ll - 0.5 * (torch.sum(d * d * c["gp_isig2"], dim=-1) + c["gp_norm"])
    return ll


def cube_to_params_core(u, c):
    lo, hi = c["lo"], c["hi"]
    return lo + torch.as_tensor(u, dtype=torch.float32) * (hi - lo)


def loglike_cube_core(u, c, s: StaticSpec, prob=None):
    """Log-likelihood of unit-cube points.  With ``prob`` (B,) int32, ``c``
    is a stacked set (:func:`mcalf_torch.models.batched.stack_problems`
    carried by :func:`consts_from_numpy`), ``u`` is (B, ndim), and row b
    belongs to problem prob[b]."""
    if prob is not None:
        c = row_consts(c, prob)
    # dz derived straight from the unit cube: resolution eps * zspan (~2.4e-9
    # in z) instead of the f32 redshift's eps * (1+z) ~ 2.4e-7 -- see the
    # d0/zmid note in build_consts.
    u = torch.as_tensor(u, dtype=torch.float32)
    dz = (u[..., c["u_zidx"]] - 0.5) * c["zspan"]
    return loglike_core(cube_to_params_core(u, c), c, s, dz=dz, prob=prob)


#: stacked tables that the kernels index by problem themselves, or that the
#: likelihood outside the fused kernel reads per row by problem
_KERNEL_TABLES = ("d0", "c_over_wave", "data", "ivar", "inv_noise", "noise", "valid")
#: per-problem constants the likelihood reads per row, gathered by problem
_ROW_KEYS = (
    "zmid", "zspan", "lo", "hi", "contval", "fixed_specres", "velstep",
    "const_term", "cdf4", "cdf5", "grace", "inv_wrest_cm", "gamma", "f",
    "taps", "gp_mu", "gp_isig2", "gp_norm",
)


def row_consts(c: Mapping[str, torch.Tensor], prob: torch.Tensor) -> Dict[str, Any]:
    """Stacked constants -> what the likelihood of a stacked batch reads:
    the per-problem scalars and tables of :data:`_ROW_KEYS` gathered per row
    by ``prob``, the kernel's stacked tables and the shared layout and mode
    tables as they are."""
    out = {k: c[k] for k in _KERNEL_TABLES + ("pidx", "comp_id", "is_fill",
                                             "u_zidx", "tmin", "modes") if k in c}
    out.update((k, c[k][prob]) for k in _ROW_KEYS if k in c)
    return out


# ---------------------------------------------------------------------------
# Modules: one problem, and several stacked.
# ---------------------------------------------------------------------------

class _HeldConsts(nn.Module):
    """Constants and the kernels' per-transition tables (always those of
    ``static``) held as buffers, plus the (name, tensor) pairs of
    ``extra``."""

    def __init__(self, static: StaticSpec, consts: Mapping[str, torch.Tensor], extra=()):
        super().__init__()
        check_supported(static.ntrans, static.npix, static.half)
        self.static = static
        self.ndim = static.ndim
        self.npix = static.npix
        device = consts["d0"].device
        tables = {
            "tmin": torch.tensor(
                static.win_tmin or (0.0,) * static.ntrans,
                dtype=torch.float32, device=device,
            ),
            "modes": torch.tensor(line_modes(static), dtype=torch.int32, device=device),
        }
        tables.update(extra)
        names = [k for k in consts if k not in tables]
        for k in names:
            self.register_buffer(k, consts[k])
        for k, v in tables.items():
            self.register_buffer(k, v)
        self._names = tuple(names) + tuple(tables)

    def consts(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._names}


class TorchForward(_HeldConsts):
    """Forward model + likelihood of one fit problem, its constants held as
    buffers on one device.  Every method takes arbitrary leading batch axes
    on ``p`` (physical parameters, (..., ndim)) or ``u`` (unit cube)."""

    def loglike_cube(self, u):
        """(..., ndim) unit-cube points -> (...) log-likelihood."""
        return loglike_cube_core(u, self.consts(), self.static)

    def cube_to_params(self, u):
        return cube_to_params_core(u, self.consts())

    def loglike(self, p):
        """(..., ndim) physical parameters -> (...) log-likelihood."""
        return loglike_core(p, self.consts(), self.static)

    def reconstruct(self, p, dz=None):
        """(..., ndim) physical parameters -> (..., P) model flux.  ``dz``:
        optional (..., T) z - zmid per transition, formed in float64 by the
        caller (see build_consts); recovered from p in float32 when None."""
        return reconstruct_core(p, self.consts(), self.static, dz=dz)

    def chi2(self, p):
        """(..., ndim) physical parameters -> (...) chi^2 of the model flux."""
        return chi2_core(p, self.consts(), self.static)


def make_torch_forward(
    model: AbsorptionModel,
    device: "torch.device | str" = "cuda",
    conv_mode: str = "same_edge",
    gpriors: bool = False,
) -> TorchForward:
    """Build the forward model of ``model`` on ``device`` (the GPU unless
    the caller asks for the CPU).  A CUDA device runs the kernels, a CPU
    device their plain PyTorch versions.

    ``conv_mode='same_edge'`` is the reference likelihood's convolution
    (the fused kernel's); ``'wrap'`` reproduces the numpy/plot/mock path,
    its likelihood through :meth:`TorchForward.reconstruct`."""
    s = static_spec(model, conv_mode=conv_mode, gpriors=gpriors)
    c = consts_from_numpy(build_consts(model, gpriors=gpriors), device)
    return TorchForward(s, c)


class StackedForward(_HeldConsts):
    """The likelihood of Q stacked problems that share one
    :class:`StaticSpec`, their constants held as buffers with a leading
    problem axis (the layout and mode tables shared).  One call evaluates
    rows of any of the problems, in one kernel launch on CUDA: the fused
    kernel in ``conv_mode='same_edge'``, the tau kernel in any other mode.

    With a fixed resolution each problem's LSF taps are made once here, by
    the expression :func:`fused_args` and :func:`reconstruct_core` evaluate
    for one problem, so a row's taps are that problem's bit for bit."""

    def __init__(self, static: StaticSpec, consts: Mapping[str, torch.Tensor]):
        nprob = int(consts["d0"].shape[0])
        extra = {}
        if static.half > 0 and not static.freespecres:
            extra["taps"] = torch.cat([
                gaussian_kernel(
                    ((consts["fixed_specres"][q] / FWHM_TO_SIGMA)
                     / consts["velstep"][q]).to(torch.float32),
                    static.half,
                ).reshape(1, -1)
                for q in range(nprob)
            ])
        super().__init__(static, consts, extra)
        self.nprob = nprob

    def loglike_cube(self, u, prob):
        """(B, ndim) unit-cube points, (B,) int32 problem of each row ->
        (B,) log-likelihood.

        On the CPU ``torch.pow`` and ``torch.exp`` round an element
        differently in their vectorised loop and their scalar tail, so a
        row's bits depend on where it lies in the batch: there each run of
        one problem's rows is its own call, evaluated exactly as that
        problem's batch alone would be, and a fleet member is its solo run
        bit for bit."""
        u = torch.as_tensor(u, dtype=torch.float32)
        c, s = self.consts(), self.static
        if u.device.type == "cpu":
            runs = _runs(prob)
            if len(runs) > 1:
                return torch.cat([loglike_cube_core(u[a:b], c, s, prob=prob[a:b])
                                  for a, b, _ in runs])
        return loglike_cube_core(u, c, s, prob=prob)


def make_stacked_forward(
    static: StaticSpec, stacked: Mapping[str, Any], device: "torch.device | str" = "cuda",
) -> StackedForward:
    """The :class:`StackedForward` of
    :func:`~mcalf_torch.models.batched.stack_problems`'s output on ``device``
    (the GPU unless the caller asks for the CPU)."""
    return StackedForward(static, consts_from_numpy(stacked, device))
