"""The fused Voigt likelihood: hand-written CUDA kernel + plain PyTorch twin.

Replaces the TPU kernels ``mcalf_tpu/ops/voigt_pallas.py::_ll_kernel`` and
``::_ll_kernel_win`` (entry ``likelihood_pallas``).  Per sample b:

    tau[p] = sum_t gain[b,t] H(u, a[b,t]),  u = (d0[t,p] + dz[b,t] cw[p]) / dnu[b,t]
    m      = cont[b] * lsf_convolve(exp(-tau), kern[b], 'same_edge')
    chi2   = sum_p ivar (data - m)^2,  n4/n5 = #{(data - m) inv_noise > 4/5}

with H the per-transition ``hjert_harris_win`` selection (windowed
transitions, ``tmin > 0``) or plain ``hjert_harris`` (``tmin == 0``).

What bounds it on an H100: about 5.3 MFLOP per evaluation at the flagship
shape (the jaxpr census of the JAX package, mostly the Harris/Dawson
polynomial and ``expf`` over T x P = 22 x 1999 (transition, pixel) pairs)
against about 8 bytes x P of device-memory traffic per sample (the
L2-resident d0 table aside), so it is compute-bound on the special
functions, not on memory.  The design answers that with a per-pixel
branch: wing pixels of a windowed transition (u^2 >= tmin, most of the
spectrum for narrow lines) take the 7-term wing polynomial and skip the
exponential and the four-region Dawson evaluation; warps diverge only at
the edges of each line's Harris interval.  One CTA per sample keeps exp(-tau)
in shared memory for the convolution and reduces chi^2 in-block, so
nothing but the three (B,) outputs touches device memory.

:func:`fused_loglike` dispatches on where its tensors live: CPU tensors
take :func:`fused_loglike_plain`; CUDA tensors launch the kernel (or
raise).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from mcalf_torch.ops.faddeeva import hjert_harris, hjert_wing

__all__ = ["fused_loglike", "fused_loglike_plain", "check_supported", "launches"]

#: number of CUDA kernel launches made by :func:`fused_loglike`
launches = 0

#: shared memory a CTA may use on Hopper (bytes)
_SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point (built at first use)."""
    from mcalf_torch.ops._build import load

    fn = load("fused_loglike").lib.mcalf_fused_loglike
    fn.restype = ctypes.c_int
    # 15 pointers, B, T, P, half, kern_stride, cont_stride, asymm, stream
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def check_supported(harris: Sequence[bool], T: int, P: int, half: int) -> None:
    """Raise on what the kernel (and its plain twin) does not compute."""
    if len(harris) != T:
        raise ValueError(f"harris flags cover {len(harris)} transitions, need {T}")
    bad = [t for t, h in enumerate(harris) if not h]
    if bad:
        raise NotImplementedError(
            f"transitions {bad} are outside the Harris regime (prior-bound "
            "damping a >= HARRIS_A_MAX); the Algorithm-916/asymptotic branch "
            "is not ported yet (ROADMAP Queue 1: non-Harris transitions)"
        )
    smem = 4 * (5 * T + 2 * half + 1 + P)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"spectrum of {P} pixels needs {smem} bytes of shared memory per "
            f"CTA, over the {_SMEM_LIMIT} a Hopper CTA can hold"
        )


def fused_loglike_plain(
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin,
    *, half: int, asymm: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same arguments, same math).

    Like the kernel, a windowed transition evaluates the Harris expansion
    only on the pixels with u^2 < tmin and the wing polynomial elsewhere:
    the same per-element selection as ``hjert_harris_win``."""
    B, T = dz.shape
    P = cw.shape[0]
    idnu = 1.0 / dnu
    tmin = tmin.tolist()
    tau = torch.zeros((B, P), dtype=torch.float32, device=dz.device)
    for t in range(T):
        u = (d0[t] + dz[:, t : t + 1] * cw) * idnu[:, t : t + 1]
        a = av[:, t : t + 1]
        if tmin[t] > 0.0:
            H = hjert_wing(u, a).reshape(-1)
            near = (u * u < tmin[t]).reshape(-1).nonzero().squeeze(1)
            H[near] = hjert_harris(
                u.reshape(-1)[near], a.expand(B, P).reshape(-1)[near]
            )
            H = H.reshape(B, P)
        else:
            H = hjert_harris(u, a)
        tau += gain[:, t : t + 1] * H
    flux = torch.exp(-tau)
    if half > 0 and P > 2 * half:
        # interior pixels: each sample's K taps slid along its own row (a
        # grouped 'valid' correlation; the kernels are symmetric)
        m = flux.clone()
        m[:, half : P - half] = F.conv1d(
            flux[None], kern.expand(B, 2 * half + 1)[:, None, :], groups=B
        )[0]
    else:
        m = flux
    m = m * cont.expand(B)[:, None]
    r = data - m
    chi2 = torch.sum(ivar * r * r, dim=1)
    if asymm:
        rn = r * inv_noise
        n4 = torch.sum(rn > 4.0, dim=1).to(torch.float32)
        n5 = torch.sum(rn > 5.0, dim=1).to(torch.float32)
    else:
        n4 = n5 = torch.zeros((B,), dtype=torch.float32, device=dz.device)
    return chi2, n4, n5


def fused_loglike(
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin,
    *, harris: Sequence[bool], half: int, asymm: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused chi^2 and asymmlike counts (n4, n5) for a batch of samples.

    dz, gain, av, dnu : (B, T) float32 per-sample per-transition scalars
        (dz = z - zmid; gain includes the activity mask and amplitude).
    d0 : (T, P) the f64-built (1 + zmid) c/lam - nu0 table; cw, data, ivar,
        inv_noise : (P,).  kern : (B, K) or (1, K) normalized LSF taps,
        K = 2*half + 1; cont : (B,) or (1,).  tmin : (T,) wing thresholds
        (0 = plain Harris).  ``harris`` : static per-transition flags.
    Returns (chi2, n4, n5), each (B,) float32 (n4 = n5 = 0 unless asymm).
    """
    B, T = dz.shape
    P = cw.shape[0]
    check_supported(harris, T, P, half)
    if dz.device.type == "cpu":
        return fused_loglike_plain(
            dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont,
            tmin, half=half, asymm=asymm,
        )
    if dz.device.type != "cuda":
        raise ValueError(f"fused_loglike runs on cpu or cuda, not {dz.device}")

    K = 2 * half + 1
    args = (dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin)
    for name, x in zip(
        ("dz", "gain", "av", "dnu", "d0", "cw", "data", "ivar", "inv_noise",
         "kern", "cont", "tmin"), args,
    ):
        if x.device != dz.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dz.device}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    for name, x in (("gain", gain), ("av", av), ("dnu", dnu)):
        if x.shape != (B, T):
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {(B, T)}")
    if d0.shape != (T, P) or tmin.shape != (T,):
        raise ValueError(f"d0 {tuple(d0.shape)} / tmin {tuple(tmin.shape)} mismatch")
    for name, x in (("data", data), ("ivar", ivar), ("inv_noise", inv_noise)):
        if x.shape != (P,):
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {(P,)}")
    if kern.dim() != 2 or kern.shape[1] != K or kern.shape[0] not in (1, B):
        raise ValueError(f"kern: shape {tuple(kern.shape)}, need (B or 1, {K})")
    if cont.dim() != 1 or cont.shape[0] not in (1, B):
        raise ValueError(f"cont: shape {tuple(cont.shape)}, need (B or 1,)")

    chi2 = torch.empty((B,), dtype=torch.float32, device=dz.device)
    n4 = torch.empty_like(chi2)
    n5 = torch.empty_like(chi2)
    if B == 0:
        return chi2, n4, n5
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    err = _kernel_fn()(
        *(x.data_ptr() for x in args),
        chi2.data_ptr(), n4.data_ptr(), n5.data_ptr(),
        B, T, P, half,
        K if kern.shape[0] == B else 0,
        1 if cont.shape[0] == B else 0,
        int(bool(asymm)),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_loglike kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return chi2, n4, n5
