"""The port's two CUDA kernels and their plain PyTorch twins.

* :func:`voigt_tau` -- the Voigt optical depth (``csrc/voigt_tau.cu``),
  replacing the TPU kernel ``mcalf_tpu/ops/voigt_pallas.py::_tau_kernel``
  (entry ``voigt_tau_pallas``)::

      tau[b, p] = sum_t gain[b,t] H_t(u, a[b,t]),
      u = (d0[t,p] + dz[b,t] cw[p]) / dnu[b,t]

* :func:`fused_loglike` -- the whole likelihood in one kernel
  (``csrc/fused_loglike.cu``), replacing ``::_ll_kernel`` and
  ``::_ll_kernel_win`` (entry ``likelihood_pallas``)::

      m    = cont[b] * lsf_convolve(exp(-tau), kern[b], 'same_edge')
      chi2 = sum_p ivar (data - m)^2,  n4/n5 = #{(data - m) inv_noise > 4/5}

``H_t`` is chosen per transition by the int32 mode table (the JAX
package's static per-transition choice in ``_accum_tau``):
:data:`MODE_HARRIS` the plain Harris expansion, :data:`MODE_WINDOWED` the
``hjert_harris_win`` selection with threshold ``tmin[t]``, and
:data:`MODE_HJERT` the full ``hjert`` (Algorithm 916 / asymptotic) of a
strongly damped transition.

Each wrapper dispatches on where its tensors live: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  ``launches`` and
``tau_launches`` count kernel launches.  The kernels' design and what
bounds them are noted in their sources.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from mcalf_torch.ops.faddeeva import N_TERMS, hjert, hjert_harris, hjert_wing

__all__ = [
    "MODE_HARRIS",
    "MODE_WINDOWED",
    "MODE_HJERT",
    "voigt_tau",
    "voigt_tau_plain",
    "fused_loglike",
    "fused_loglike_plain",
    "check_supported",
    "launches",
    "tau_launches",
]

MODE_HARRIS, MODE_WINDOWED, MODE_HJERT = 0, 1, 2

#: number of CUDA kernel launches made by :func:`fused_loglike`
launches = 0
#: number of CUDA kernel launches made by :func:`voigt_tau`
tau_launches = 0

#: shared memory a CTA may use on Hopper (bytes)
_SMEM_LIMIT = 232448
#: 32-bit words of shared memory per transition (csrc/voigt_h.cuh kLineWords)
_LINE_WORDS = 7 + N_TERMS + 1


@functools.lru_cache(maxsize=None)
def _fused_fn():
    """The fused kernel's C entry point (the library is built at first use)."""
    from mcalf_torch.ops._build import load

    fn = load().lib.mcalf_fused_loglike
    fn.restype = ctypes.c_int
    # 16 pointers, B, T, P, half, kern_stride, cont_stride, asymm, stream
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _tau_fn():
    """The tau kernel's C entry point (the library is built at first use)."""
    from mcalf_torch.ops._build import load

    fn = load().lib.mcalf_voigt_tau
    fn.restype = ctypes.c_int
    # 9 pointers, B, T, P, stream
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def smem_bytes(T: int, P: int = 0, K: int = 0) -> int:
    """Dynamic shared memory of one CTA: the line tables, plus the LSF taps
    and the flux row for the fused kernel."""
    return 4 * (_LINE_WORDS * T + K + P)


def check_supported(T: int, P: int, half: int) -> None:
    """Raise when one sample's spectrum and line tables do not fit the
    shared memory of a Hopper CTA (the fused kernel's limit)."""
    smem = smem_bytes(T, P, 2 * half + 1)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"spectrum of {P} pixels with {T} transitions needs {smem} bytes "
            f"of shared memory per CTA, over the {_SMEM_LIMIT} a Hopper CTA "
            "can hold"
        )


def _check_cuda_inputs(B, T, P, named, modes) -> None:
    """What the kernels read: contiguous float32 on one device, int32 modes."""
    device = named[0][1].device
    for name, x in named:
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {device}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    if modes.device != device or modes.dtype != torch.int32 or not modes.is_contiguous():
        raise ValueError(
            f"modes: need a contiguous int32 tensor on {device}, got "
            f"{modes.dtype} on {modes.device}"
        )
    shapes = dict(named)
    for name in ("gain", "av", "dnu"):
        if shapes[name].shape != (B, T):
            raise ValueError(f"{name}: shape {tuple(shapes[name].shape)} != {(B, T)}")
    if shapes["d0"].shape != (T, P) or shapes["tmin"].shape != (T,) or modes.shape != (T,):
        raise ValueError(
            f"d0 {tuple(shapes['d0'].shape)} / tmin {tuple(shapes['tmin'].shape)} "
            f"/ modes {tuple(modes.shape)} do not match T={T}, P={P}"
        )


def voigt_tau_plain(dz, gain, av, dnu, d0, cw, tmin, modes) -> torch.Tensor:
    """Plain PyTorch version of the tau kernel (same arguments, same math).

    A windowed transition evaluates the Harris expansion only on the pixels
    with u^2 < tmin and the wing polynomial elsewhere (the same per-element
    selection as ``hjert_harris_win``); a strongly damped one takes
    :func:`~mcalf_torch.ops.faddeeva.hjert`."""
    B, T = dz.shape
    P = cw.shape[0]
    idnu = 1.0 / dnu
    cw64 = cw.double()
    tau = torch.zeros((B, P), dtype=torch.float32, device=dz.device)
    for t, (mode, tm) in enumerate(zip(modes.tolist(), tmin.tolist())):
        # d0 + dz cw rounded once, as the kernels' fused multiply-add does
        # (the float32 product is exact in float64): for a filler line with
        # a wide redshift prior the two terms nearly cancel, and a rounded
        # product would move u by ~1e-5 there
        s = (d0[t].double() + dz[:, t : t + 1].double() * cw64).float()
        u = s * idnu[:, t : t + 1]
        a = av[:, t : t + 1]
        if mode == MODE_HJERT:
            H = hjert(u, a)
        elif mode == MODE_WINDOWED:
            H = hjert_wing(u, a).reshape(-1)
            near = (u * u < tm).reshape(-1).nonzero().squeeze(1)
            H[near] = hjert_harris(
                u.reshape(-1)[near], a.expand(B, P).reshape(-1)[near]
            )
            H = H.reshape(B, P)
        elif mode == MODE_HARRIS:
            H = hjert_harris(u, a)
        else:
            raise ValueError(f"transition {t}: unknown mode {mode}")
        tau += gain[:, t : t + 1] * H
    return tau


def voigt_tau(dz, gain, av, dnu, d0, cw, tmin, modes) -> torch.Tensor:
    """Voigt optical depth (B, P) for a batch of samples.

    dz, gain, av, dnu : (B, T) float32 per-sample per-transition scalars
        (dz = z - zmid; gain includes the activity mask and amplitude).
    d0 : (T, P) the f64-built (1 + zmid) c/lam - nu0 table; cw : (P,).
    tmin : (T,) float32 wing thresholds of the windowed transitions;
    modes : (T,) int32 per-transition modes (MODE_*).
    """
    B, T = dz.shape
    P = cw.shape[0]
    if dz.device.type == "cpu":
        return voigt_tau_plain(dz, gain, av, dnu, d0, cw, tmin, modes)
    if dz.device.type != "cuda":
        raise ValueError(f"voigt_tau runs on cpu or cuda, not {dz.device}")
    named = (("dz", dz), ("gain", gain), ("av", av), ("dnu", dnu), ("d0", d0),
             ("cw", cw), ("tmin", tmin))
    _check_cuda_inputs(B, T, P, named, modes)
    if smem_bytes(T) > _SMEM_LIMIT:
        raise ValueError(f"{T} transitions need more shared memory than a CTA has")
    tau = torch.empty((B, P), dtype=torch.float32, device=dz.device)
    if B == 0 or P == 0:
        return tau
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    err = _tau_fn()(
        *(x.data_ptr() for _, x in named), modes.data_ptr(), tau.data_ptr(),
        B, T, P, stream,
    )
    if err != 0:
        raise RuntimeError(f"voigt_tau kernel launch failed: CUDA error {err}")
    global tau_launches
    tau_launches += 1
    return tau


def fused_loglike_plain(
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, modes,
    *, half: int, asymm: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel (same arguments, same
    math): :func:`voigt_tau_plain`, then the likelihood tail."""
    B = dz.shape[0]
    P = cw.shape[0]
    tau = voigt_tau_plain(dz, gain, av, dnu, d0, cw, tmin, modes)
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
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, modes,
    *, half: int, asymm: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused chi^2 and asymmlike counts (n4, n5) for a batch of samples.

    dz ... d0, cw, tmin, modes : as for :func:`voigt_tau`.  data, ivar,
    inv_noise : (P,).  kern : (B, K) or (1, K) normalized LSF taps,
    K = 2*half + 1; cont : (B,) or (1,).
    Returns (chi2, n4, n5), each (B,) float32 (n4 = n5 = 0 unless asymm).
    """
    B, T = dz.shape
    P = cw.shape[0]
    check_supported(T, P, half)
    if dz.device.type == "cpu":
        return fused_loglike_plain(
            dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont,
            tmin, modes, half=half, asymm=asymm,
        )
    if dz.device.type != "cuda":
        raise ValueError(f"fused_loglike runs on cpu or cuda, not {dz.device}")

    K = 2 * half + 1
    named = (("dz", dz), ("gain", gain), ("av", av), ("dnu", dnu), ("d0", d0),
             ("cw", cw), ("data", data), ("ivar", ivar), ("inv_noise", inv_noise),
             ("kern", kern), ("cont", cont), ("tmin", tmin))
    _check_cuda_inputs(B, T, P, named, modes)
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
    err = _fused_fn()(
        *(x.data_ptr() for _, x in named), modes.data_ptr(),
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
