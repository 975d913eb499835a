"""The port's two CUDA kernels and their plain PyTorch twins.

* :func:`voigt_tau` -- the Voigt optical depth (``csrc/voigt_tau.cu``),
  replacing the TPU kernel ``mcalf_tpu/ops/voigt_pallas.py::_tau_kernel``
  (entry ``voigt_tau_pallas``)::

      tau[b, p] = sum_t gain[b,t] H_t(u, a[b,t]),
      u = (d0[t,p] + dz[b,t] cw[p]) / dnu[b,t]

  with an optional problem axis like the fused kernel's (d0 (Q, T, P) and
  cw (Q, P) indexed by ``prob[b]``);

* :func:`fused_loglike` -- the whole likelihood in one kernel
  (``csrc/fused_loglike.cu``), replacing ``::_ll_kernel`` and
  ``::_ll_kernel_win`` (entry ``likelihood_pallas``)::

      m    = cont[b] * lsf_convolve(exp(-tau), kern[b], 'same_edge')
      chi2 = sum_p ivar (data - m)^2,  n4/n5 = #{(data - m) inv_noise > 4/5}

  with an optional problem axis: given ``prob`` (B,), sample b reads
  problem prob[b]'s d0, cw, data, ivar and inv_noise out of stacked
  (Q, T, P) and (Q, P) tables (the fleet's stacked problems, one launch
  for all of them).

``H_t`` is chosen per transition by the int32 mode table (the JAX
package's static per-transition choice in ``_accum_tau``):
:data:`MODE_HARRIS` the plain Harris expansion, :data:`MODE_WINDOWED` the
``hjert_harris_win`` selection with threshold ``tmin[t]``, and
:data:`MODE_HJERT` the full ``hjert`` (Algorithm 916 / asymptotic) of a
strongly damped transition.

Each wrapper dispatches on where its tensors live: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  ``launches`` and
``tau_launches`` count kernel launches as the card runs them: a launch
captured in a CUDA graph counts at each replay
(:func:`mcalf_torch.utils.profiling.count_launch`).  The kernels' design and what
bounds them are noted in their sources; their launch geometries (the fused
kernel's thread block cluster per sample, the tau kernel's CTA per sample
group and pixel tile) are :func:`fused_geometry`'s and
:func:`tau_geometry`'s, here, where the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from mcalf_torch.ops.faddeeva import N_TERMS, hjert, hjert_harris, hjert_wing
from mcalf_torch.utils.profiling import count_launch

__all__ = [
    "MODE_HARRIS",
    "MODE_WINDOWED",
    "MODE_HJERT",
    "voigt_tau",
    "voigt_tau_plain",
    "fused_loglike",
    "fused_loglike_plain",
    "check_supported",
    "fused_geometry",
    "fused_occupancy",
    "FusedGeometry",
    "tau_geometry",
    "tau_occupancy",
    "TauGeometry",
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
#: threads per CTA of the fused kernel (csrc/fused_loglike.cu kThreads)
THREADS = 256
#: CTAs per thread block cluster at most (csrc/fused_loglike.cu kMaxCluster)
MAX_CLUSTER = 8
#: 32-bit words of shared memory per transition (csrc/voigt_h.cuh kLineWords)
_LINE_WORDS = 8 + N_TERMS
#: threads per CTA of the tau kernel at most (csrc/voigt_tau.cu kMaxThreads)
TAU_MAX_THREADS = 256
#: samples per group of the tau kernel's Harris-only and damped
#: instantiations at most (csrc/voigt_tau.cu kHarrisMaxSamples,
#: kDampedMaxSamples)
TAU_MAX_SAMPLES = {False: 4, True: 2}
#: threads per CTA (pixels per tile) of the tau kernel's Harris-only and
#: damped instantiations
TAU_THREADS = {False: 128, True: 256}
#: warps of work per SM below which the tau kernel's geometry takes fewer
#: samples per group (tools/tau_steps.py: the damped kernel's tiles differ
#: more in cost, so it wants more of them)
TAU_WARPS_PER_SM = {False: 24, True: 48}
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _fused_fn():
    """The fused kernel's C entry point (the library is built at first use)."""
    from mcalf_torch.ops._build import load

    fn = load().lib.mcalf_fused_loglike
    fn.restype = ctypes.c_int
    # 17 pointers (prob may be null), B, T, P, half, tile, cluster, smem,
    # kern_stride, cont_stride, asymm, damped, stream
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _tau_fn():
    """The tau kernel's C entry point (the library is built at first use)."""
    from mcalf_torch.ops._build import load

    fn = load().lib.mcalf_voigt_tau_groups
    fn.restype = ctypes.c_int
    # 10 pointers (prob may be null), B, T, P, damped, samples, threads,
    # ntiles, grid, smem, stream
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return fn


class FusedGeometry(NamedTuple):
    """How :func:`fused_loglike` lays one sample's spectrum over a thread
    block cluster (``csrc/fused_loglike.cu``)."""

    #: threads per CTA (one pixel each per step)
    threads: int
    #: CTAs per sample: one thread block cluster of this many CTAs
    cluster: int
    #: pixels each CTA owns, [r*tile, min((r+1)*tile, P)) for CTA r
    tile: int
    #: pixels each CTA reads from either neighbour (the LSF's half width)
    halo: int
    #: dynamic shared memory of one CTA in bytes
    smem: int

    def tiles(self, P: int):
        """The (start, stop) pixel range of each CTA of the cluster."""
        return [(r * self.tile, min((r + 1) * self.tile, P)) for r in range(self.cluster)]


@functools.lru_cache(maxsize=None)
def fused_geometry(T: int, P: int, half: int) -> FusedGeometry:
    """The fused kernel's launch geometry for T transitions, P pixels and an
    LSF of 2*half + 1 taps.

    One tile of :data:`THREADS` pixels per CTA, at most
    :data:`MAX_CLUSTER` CTAs per sample (the portable cluster size; a longer
    spectrum gives each CTA a longer tile), every CTA owning at least one
    pixel and, when there are neighbours, at least ``half`` (a halo then
    comes from the immediate neighbour only).  Raises ``ValueError`` when a
    CTA's line tables, taps and tile do not fit its shared memory."""
    cluster = max(1, min(MAX_CLUSTER, -(-P // THREADS)))
    while cluster > 1 and (-(-P // cluster) < half or (cluster - 1) * -(-P // cluster) >= P):
        cluster -= 1
    tile = -(-P // cluster)
    smem = 4 * (_LINE_WORDS * T + (2 * half + 1) + tile + 2 * half)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{T} transitions and a tile of {tile} pixels (P={P}, half={half}) "
            f"need {smem} bytes of shared memory per CTA, over the "
            f"{_SMEM_LIMIT} a Hopper CTA can hold"
        )
    return FusedGeometry(THREADS, cluster, tile, half, smem)


def check_supported(T: int, P: int, half: int) -> None:
    """Raise when the fused kernel cannot take T transitions, P pixels and
    this LSF (see :func:`fused_geometry`)."""
    fused_geometry(T, P, half)


def fused_occupancy(T: int, P: int, half: int, damped: bool) -> Tuple[int, int]:
    """(CTAs resident per SM, clusters resident on the card) of the fused
    kernel at this geometry, as the CUDA runtime computes them; ``damped``
    picks the instantiation for a model with a strongly damped transition."""
    from mcalf_torch.ops._build import load

    g = fused_geometry(T, P, half)
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    fn = load().lib.mcalf_fused_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    err = fn(T, P, half, g.tile, g.cluster, g.smem, int(damped),
             ctypes.addressof(ctas), ctypes.addressof(clusters))
    if err != 0:
        raise RuntimeError(f"fused kernel occupancy query failed: CUDA error {err}")
    return ctas.value, clusters.value


class TauGeometry(NamedTuple):
    """How :func:`voigt_tau` lays its work over CTAs (``csrc/voigt_tau.cu``):
    CTA i takes pixel tile i % ntiles of sample group i // ntiles."""

    #: threads per CTA, one pixel each
    threads: int
    #: samples per group (S), each thread's independent sums; the last
    #: group holds the B % S samples left over, if any
    samples: int
    #: pixels per tile (= threads)
    tile: int
    #: pixel tiles per sample group
    ntiles: int
    #: CTAs launched, one per (sample group, pixel tile)
    grid: int
    #: dynamic shared memory of one CTA in bytes (one group's line tables)
    smem: int


def _tau_layout(B: int, T: int, P: int, samples: int, threads: int) -> TauGeometry:
    """The geometry for groups of `samples` samples and tiles of `threads`
    pixels.  Raises ``ValueError`` when a group's line tables do not fit a
    CTA's shared memory."""
    smem = 4 * _LINE_WORDS * T * samples
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{T} transitions of {samples} samples need {smem} bytes of shared "
            f"memory per CTA, over the {_SMEM_LIMIT} a Hopper CTA can hold"
        )
    ntiles = -(-P // threads)
    grid = -(-B // samples) * ntiles
    if grid >= 2**31:
        raise ValueError(f"B={B}, P={P}: {grid} CTAs, over 2**31 - 1")
    return TauGeometry(threads, samples, threads, ntiles, grid, smem)


@functools.lru_cache(maxsize=None)
def tau_geometry(B: int, T: int, P: int, damped: bool, sms: int = H100_SMS) -> TauGeometry:
    """The tau kernel's launch geometry for B samples, T transitions and P
    pixels on a card of ``sms`` SMs; ``damped`` picks the instantiation.

    Tiles of ``TAU_THREADS[damped]`` pixels and groups of S samples: the
    largest S of 4, 2, 1 up to ``TAU_MAX_SAMPLES[damped]`` whose work items
    still give every SM at least ``TAU_WARPS_PER_SM[damped]`` warps (S = 1
    when none does), since larger groups share each d0 load and table load
    among more samples but leave fewer CTAs to hide latency and even out the
    cost of the tiles.  Raises ``ValueError`` when a group's line tables do
    not fit a CTA's shared memory."""
    threads = TAU_THREADS[damped]
    warps = -(-P // threads) * (threads // 32)
    S = next((S for S in (4, 2) if S <= TAU_MAX_SAMPLES[damped]
              and -(-B // S) * warps >= TAU_WARPS_PER_SM[damped] * sms), 1)
    return _tau_layout(B, T, P, S, threads)


def tau_occupancy(damped: bool, geo: TauGeometry) -> int:
    """CTAs of the tau kernel resident per SM at this geometry, as the CUDA
    runtime computes them; ``damped`` picks the instantiation."""
    from mcalf_torch.ops._build import load

    ctas = ctypes.c_int(0)
    fn = load().lib.mcalf_voigt_tau_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    err = fn(int(damped), geo.threads, geo.smem, ctypes.addressof(ctas))
    if err != 0:
        raise RuntimeError(f"tau kernel occupancy query failed: CUDA error {err}")
    return ctas.value


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: id(modes) -> (weak reference to it, its version, any mode-2 transition)
_DAMPED = {}


def _any_damped(modes: torch.Tensor) -> bool:
    """Whether the mode table holds a strongly damped transition: each
    kernel is compiled once for each case.  Read from the device once per
    table (one synchronisation) and kept while that tensor lives unchanged:
    a model passes the same table to every call."""
    hit = _DAMPED.get(id(modes))
    if hit is not None and hit[0]() is modes and hit[1] == modes._version:
        return hit[2]
    damped = bool((modes == MODE_HJERT).any())
    key = id(modes)
    _DAMPED[key] = (weakref.ref(modes, lambda _: _DAMPED.pop(key, None)),
                    modes._version, damped)
    return damped


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
    if shapes["d0"].shape[-2:] != (T, P) or shapes["tmin"].shape != (T,) or modes.shape != (T,):
        raise ValueError(
            f"d0 {tuple(shapes['d0'].shape)} / tmin {tuple(shapes['tmin'].shape)} "
            f"/ modes {tuple(modes.shape)} do not match T={T}, P={P}"
        )


def voigt_tau_plain(dz, gain, av, dnu, d0, cw, tmin, modes, prob=None) -> torch.Tensor:
    """Plain PyTorch version of the tau kernel (same arguments, same math).

    A windowed transition evaluates the Harris expansion only on the pixels
    with u^2 < tmin and the wing polynomial elsewhere (the same per-element
    selection as ``hjert_harris_win``); a strongly damped one takes
    :func:`~mcalf_torch.ops.faddeeva.hjert`.

    With ``prob``, each run of consecutive samples of one problem is one
    call on that problem's tables: on the CPU ``torch.pow`` and
    ``torch.exp`` round an element differently in their vectorised loop and
    their scalar tail, so a run is evaluated exactly as a batch of that
    problem alone would be."""
    if prob is not None:
        if dz.shape[0] == 0:
            return torch.zeros((0, cw.shape[-1]), dtype=torch.float32, device=dz.device)
        return torch.cat([
            voigt_tau_plain(dz[a:b], gain[a:b], av[a:b], dnu[a:b], d0[q], cw[q], tmin, modes)
            for a, b, q in _runs(prob)
        ])
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


def _check_prob(prob, dz, d0, B: int) -> None:
    """What a kernel reads of a problem axis: (B,) contiguous int32 on the
    samples' device, and a d0 its int32 offsets can index."""
    if prob.device != dz.device or prob.dtype != torch.int32 or not prob.is_contiguous():
        raise ValueError(f"prob: need a contiguous int32 tensor on {dz.device}, got "
                         f"{prob.dtype} on {prob.device}")
    if prob.shape != (B,):
        raise ValueError(f"prob: shape {tuple(prob.shape)} != {(B,)}")
    if d0.numel() >= 2**31:
        raise ValueError(f"d0: {d0.numel()} elements, over the kernel's int32 index")


def voigt_tau(dz, gain, av, dnu, d0, cw, tmin, modes, prob=None) -> torch.Tensor:
    """Voigt optical depth (B, P) for a batch of samples.

    dz, gain, av, dnu : (B, T) float32 per-sample per-transition scalars
        (dz = z - zmid; gain includes the activity mask and amplitude).
    d0 : (T, P) the f64-built (1 + zmid) c/lam - nu0 table; cw : (P,).
    tmin : (T,) float32 wing thresholds of the windowed transitions;
    modes : (T,) int32 per-transition modes (MODE_*).
    prob : optional (B,) int32 problem of each sample; d0 is then
    (Q, T, P) and cw (Q, P), and every entry of prob must lie in [0, Q)
    (the kernel does not check it: that would cost a device read per call).
    """
    B, T = dz.shape
    P = cw.shape[-1]
    if dz.device.type == "cpu":
        return voigt_tau_plain(dz, gain, av, dnu, d0, cw, tmin, modes, prob)
    if dz.device.type != "cuda":
        raise ValueError(f"voigt_tau runs on cpu or cuda, not {dz.device}")
    named = (("dz", dz), ("gain", gain), ("av", av), ("dnu", dnu), ("d0", d0),
             ("cw", cw), ("tmin", tmin))
    _check_cuda_inputs(B, T, P, named, modes)
    lead = () if prob is None else (d0.shape[0],)
    if d0.shape != lead + (T, P) or cw.shape != lead + (P,):
        raise ValueError(f"d0 {tuple(d0.shape)} / cw {tuple(cw.shape)}: need "
                         f"{lead + (T, P)} / {lead + (P,)}")
    if prob is not None:
        _check_prob(prob, dz, d0, B)
    damped = _any_damped(modes)
    index = dz.device.index if dz.device.index is not None else torch.cuda.current_device()
    geo = tau_geometry(B, T, P, damped, sms=_sm_count(index))
    tau = torch.empty((B, P), dtype=torch.float32, device=dz.device)
    if B == 0 or P == 0:
        return tau
    _launch_tau(named, modes, tau, damped, geo, prob)
    count_launch(_add_tau_launches)
    return tau


def _add_tau_launches(n: int) -> None:
    global tau_launches
    tau_launches += n


def _launch_tau(named, modes, tau, damped: bool, geo: TauGeometry, prob=None) -> None:
    """One launch of the tau kernel's instantiation for `damped` (and for
    a problem axis when `prob` is given) at this geometry, on the current
    stream."""
    B, P = tau.shape
    T = modes.shape[0]
    stream = torch.cuda.current_stream(tau.device).cuda_stream
    err = _tau_fn()(
        *(x.data_ptr() for _, x in named), modes.data_ptr(),
        None if prob is None else prob.data_ptr(), tau.data_ptr(),
        B, T, P, int(damped), geo.samples, geo.threads, geo.ntiles, geo.grid,
        geo.smem, stream,
    )
    if err != 0:
        raise RuntimeError(f"voigt_tau kernel launch failed: CUDA error {err}")


def _runs(prob: torch.Tensor):
    """(start, stop, problem) of each run of equal consecutive entries."""
    p = prob.tolist()
    if not p:
        return []
    starts = [0] + [i for i in range(1, len(p)) if p[i] != p[i - 1]]
    return [(a, b, p[a]) for a, b in zip(starts, starts[1:] + [len(p)])]


def fused_loglike_plain(
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, modes,
    *, half: int, asymm: bool, prob=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel (same arguments, same
    math): :func:`voigt_tau_plain`, then the likelihood tail.

    With ``prob``, each run of consecutive samples of one problem is one
    call on that problem's tables.  On the CPU two of the ops below give an
    element bits that depend on the rest of the batch (the grouped
    ``conv1d`` takes another algorithm for one group than for many), so a
    run is evaluated exactly as a batch of that problem alone would be: a
    fleet's block of B rows of problem q is the single-problem call's
    result bit for bit."""
    if prob is not None:
        outs = []
        for a, b, q in _runs(prob):
            rows = lambda x: x[a:b]
            per = lambda x: x if x.shape[0] == 1 else x[a:b]
            outs.append(fused_loglike_plain(
                rows(dz), rows(gain), rows(av), rows(dnu), d0[q], cw[q], data[q],
                ivar[q], inv_noise[q], per(kern), per(cont), tmin, modes,
                half=half, asymm=asymm,
            ))
        return tuple(torch.cat(x) for x in zip(*outs))
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
    *, half: int, asymm: bool, prob=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused chi^2 and asymmlike counts (n4, n5) for a batch of samples.

    dz ... d0, cw, tmin, modes : as for :func:`voigt_tau`.  data, ivar,
    inv_noise : (P,).  kern : (B, K) or (1, K) normalized LSF taps,
    K = 2*half + 1; cont : (B,) or (1,).
    prob : optional (B,) int32 problem of each sample; d0 is then
    (Q, T, P) and cw, data, ivar, inv_noise (Q, P), and every entry of
    prob must lie in [0, Q) (the kernel does not check it: that would cost
    a device read per call).
    Returns (chi2, n4, n5), each (B,) float32 (n4 = n5 = 0 unless asymm).
    """
    B, T = dz.shape
    P = cw.shape[-1]
    geo = fused_geometry(T, P, half)
    if dz.device.type == "cpu":
        return fused_loglike_plain(
            dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont,
            tmin, modes, half=half, asymm=asymm, prob=prob,
        )
    if dz.device.type != "cuda":
        raise ValueError(f"fused_loglike runs on cpu or cuda, not {dz.device}")

    K = 2 * half + 1
    named = (("dz", dz), ("gain", gain), ("av", av), ("dnu", dnu), ("d0", d0),
             ("cw", cw), ("data", data), ("ivar", ivar), ("inv_noise", inv_noise),
             ("kern", kern), ("cont", cont), ("tmin", tmin))
    _check_cuda_inputs(B, T, P, named, modes)
    lead = () if prob is None else (d0.shape[0],)
    if d0.shape != lead + (T, P):
        raise ValueError(f"d0: shape {tuple(d0.shape)} != {lead + (T, P)}")
    for name, x in (("cw", cw), ("data", data), ("ivar", ivar), ("inv_noise", inv_noise)):
        if x.shape != lead + (P,):
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {lead + (P,)}")
    if prob is not None:
        _check_prob(prob, dz, d0, B)
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
        None if prob is None else prob.data_ptr(),
        chi2.data_ptr(), n4.data_ptr(), n5.data_ptr(),
        B, T, P, half, geo.tile, geo.cluster, geo.smem,
        K if kern.shape[0] == B else 0,
        1 if cont.shape[0] == B else 0,
        int(bool(asymm)),
        int(_any_damped(modes)),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_loglike kernel launch failed: CUDA error {err}")
    count_launch(_add_launches)
    return chi2, n4, n5


def _add_launches(n: int) -> None:
    global launches
    launches += n
