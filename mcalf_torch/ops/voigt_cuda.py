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
  for all of them);

* :func:`fused_loglike_cube` -- the same kernel fed the rows' unit-cube
  points (the sampler's call): it makes each row's line tables, taps and
  continuum from its point and writes log L, so a likelihood call is one
  launch (:class:`CubeTables` lists what it reads besides the rows).

``H_t`` is chosen per transition by the int32 mode table (the JAX
package's static per-transition choice in ``_accum_tau``):
:data:`MODE_HARRIS` the plain Harris expansion, :data:`MODE_WINDOWED` the
``hjert_harris_win`` selection with threshold ``tmin[t]``, and
:data:`MODE_HJERT` the full ``hjert`` (Algorithm 916 / asymptotic) of a
transition whose prior allows strong damping.  The fused kernel then
chooses per line: a :data:`MODE_HJERT` line keeps the full ``hjert`` only
where its own damping ``av`` is at least ``HARRIS_A_MAX`` and its gain is
nonzero, and takes the Harris expansion elsewhere (windowed where
``tmin[t]`` is positive).  The tau kernel and the plain versions keep the
table's choice.

Each wrapper dispatches on where its tensors live: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  ``launches`` and
``tau_launches`` count kernel launches as the card runs them, and
``cube_launches`` the fused launches that built their line tables from
the unit cube; ``lines`` counts the (row, transition) pairs of the fused
launches: a launch captured in a CUDA graph counts at each replay
(:func:`mcalf_torch.utils.profiling.count_launch`).  ``hjert_lines``, the
lines of those launches that took the full ``hjert``, and ``series_evals``,
the (line, pixel) pairs of those lines that took its Algorithm 916 series,
are counted by the card itself and read (with one synchronisation) when the
name is read.
The kernels' design and what bounds them are noted in their sources;
their launch geometries (the fused
kernel's thread block cluster per sample, the tau kernel's CTA per sample
group and pixel tile) are :func:`fused_geometry`'s and
:func:`tau_geometry`'s, here, where the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Tuple

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
    "fused_loglike_cube",
    "fused_loglike_cube_plain",
    "CubeTables",
    "check_supported",
    "fused_geometry",
    "fused_occupancy",
    "FusedGeometry",
    "tau_geometry",
    "tau_occupancy",
    "TauGeometry",
    "launches",
    "cube_launches",
    "lines",
    "hjert_lines",
    "series_evals",
    "tau_launches",
]

MODE_HARRIS, MODE_WINDOWED, MODE_HJERT = 0, 1, 2

#: number of CUDA kernel launches made by :func:`fused_loglike` and
#: :func:`fused_loglike_cube`
launches = 0
#: of those, the launches made by :func:`fused_loglike_cube`
cube_launches = 0
#: rows x transitions of those launches
lines = 0
# ``hjert_lines`` (module __getattr__): of those, the lines that took the
# full Algorithm 916 / asymptotic ``hjert`` on every pixel, no wing window;
# ``series_evals`` (likewise): the (line, pixel) pairs of those lines that
# took the Algorithm 916 series (u^2 + a^2 < R2_SWITCH)
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
def _fused_cube_fn():
    """The fused kernel's C entry point for unit-cube rows."""
    from mcalf_torch.ops._build import load

    fn = load().lib.mcalf_fused_loglike_cube
    fn.restype = ctypes.c_int
    # the pointers of _CUBE_POINTERS (taps, the Gaussian priors' and prob
    # may be null), B, T, P, half, tile, cluster, smem, ndim, startind,
    # specres_at, cont_at, asymm, damped, stream
    fn.argtypes = ([ctypes.c_void_p] * len(_CUBE_POINTERS) + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
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


def fused_occupancy(T: int, P: int, half: int, damped: bool,
                    cube: bool = False) -> Tuple[int, int]:
    """(CTAs resident per SM, clusters resident on the card) of the fused
    kernel at this geometry, as the CUDA runtime computes them; ``damped``
    picks the instantiation for a model with a strongly damped transition,
    ``cube`` the one :func:`fused_loglike_cube` launches."""
    from mcalf_torch.ops._build import load

    g = fused_geometry(T, P, half)
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    fn = load().lib.mcalf_fused_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    err = fn(T, P, half, g.tile, g.cluster, g.smem, int(damped), int(cube),
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


#: id(modes) -> (weak reference to it, its version, its mode-2 transitions)
_DAMPED = {}
#: indices of the devices that ran a damped fused launch: their counters
#: hold ``hjert_lines`` and ``series_evals``
_HJERT_DEVICES = set()


def _device_counter(name: str, index: int) -> int:
    """The fused kernel's device counter ``name`` on device ``index``
    (csrc/fused_loglike.cu ``mcalf_fused_<name>``: ``hjert_lines``, one add
    a row, or ``series_evals``, one add a CTA): waits for the device's
    work, then reads it."""
    from mcalf_torch.ops._build import load

    fn = getattr(load().lib, f"mcalf_fused_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = ctypes.c_ulonglong(0)
    err = fn(index, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"reading the fused kernel's {name} failed: CUDA error {err}")
    return out.value


def __getattr__(name: str):
    # the device counters sync each device that counts them, so they are
    # read only when asked for (never per launch or per replay; not during
    # a graph capture)
    if name in ("hjert_lines", "series_evals"):
        return sum(_device_counter(name, i) for i in sorted(_HJERT_DEVICES))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _hjert_count(modes: torch.Tensor) -> int:
    """The mode table's strongly damped (:data:`MODE_HJERT`) transitions.
    Read from the device once per table (one synchronisation) and kept
    while that tensor lives unchanged: a model passes the same table to
    every call."""
    hit = _DAMPED.get(id(modes))
    if hit is not None and hit[0]() is modes and hit[1] == modes._version:
        return hit[2]
    count = int((modes == MODE_HJERT).sum())
    key = id(modes)
    _DAMPED[key] = (weakref.ref(modes, lambda _: _DAMPED.pop(key, None)),
                    modes._version, count)
    return count


def _any_damped(modes: torch.Tensor) -> bool:
    """Whether the mode table holds a strongly damped transition: each
    kernel is compiled once for each case."""
    return _hjert_count(modes) > 0


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
    damped = _any_damped(modes)
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    err = _fused_fn()(
        *(x.data_ptr() for _, x in named), modes.data_ptr(),
        None if prob is None else prob.data_ptr(),
        chi2.data_ptr(), n4.data_ptr(), n5.data_ptr(),
        B, T, P, half, geo.tile, geo.cluster, geo.smem,
        K if kern.shape[0] == B else 0,
        1 if cont.shape[0] == B else 0,
        int(bool(asymm)),
        int(damped),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_loglike kernel launch failed: CUDA error {err}")
    _counted(dz.device, damped)
    count_launch(_fused_counter(False, B, T))
    return chi2, n4, n5


def _counted(device: torch.device, damped: bool) -> None:
    """Note a fused launch's device: a damped launch counts its mode-2
    lines and series pairs there."""
    if damped:
        _HJERT_DEVICES.add(device.index if device.index is not None
                           else torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _fused_counter(cube: bool, rows: int, T: int):
    """What :func:`count_launch` calls for a fused launch of ``rows`` rows
    of ``T`` transitions: each run adds to :data:`launches` and
    :data:`lines`, and a cube launch to :data:`cube_launches`.  One function
    per launch shape, so a captured launch tallies once and a replay makes
    one call for it."""

    def add(n: int) -> None:
        global launches, cube_launches, lines
        launches += n
        cube_launches += n if cube else 0
        lines += n * rows * T

    return add


class CubeTables(NamedTuple):
    """What :func:`fused_loglike_cube` reads besides the rows: the
    per-problem tables, ``([Q,] ...)`` and read at row ``prob[b]`` (the
    whole table without a problem axis), the layout and mode tables shared
    by every problem, and three columns of the parameter vector.
    ``mcalf_torch.models.torch_model.cube_tables`` makes it from a forward
    model's constants."""

    lo: torch.Tensor            # ([Q,] ndim) prior box
    hi: torch.Tensor            # ([Q,] ndim)
    zspan: torch.Tensor         # ([Q,] T) redshift prior width per transition
    inv_wrest_cm: torch.Tensor  # ([Q,] T)
    gamma: torch.Tensor         # ([Q,] T)
    f: torch.Tensor             # ([Q,] T)
    taps: Optional[torch.Tensor]  # ([Q,] K) a fixed resolution's LSF; None: free
    velstep: torch.Tensor       # ([Q,])
    contval: torch.Tensor       # ([Q,]) a fixed continuum
    const_term: torch.Tensor    # ([Q,])
    cdf4: torch.Tensor          # ([Q,])
    cdf5: torch.Tensor          # ([Q,])
    grace: torch.Tensor         # ([Q,])
    gp_mu: Optional[torch.Tensor]     # ([Q,] ndim); None: no Gaussian priors
    gp_isig2: Optional[torch.Tensor]  # ([Q,] ndim)
    gp_norm: Optional[torch.Tensor]   # ([Q,])
    d0: torch.Tensor            # ([Q,] T, P)
    cw: torch.Tensor            # ([Q,] P)
    data: torch.Tensor          # ([Q,] P)
    ivar: torch.Tensor          # ([Q,] P)
    inv_noise: torch.Tensor     # ([Q,] P)
    pidx: torch.Tensor          # (T,) int64 column of each transition's log N
    u_zidx: torch.Tensor        # (T,) int64 column of its redshift
    comp_id: torch.Tensor       # (T,) float32 component of each transition
    is_fill: torch.Tensor       # (T,) bool filler transitions (always active)
    tmin: torch.Tensor          # (T,) float32
    modes: torch.Tensor         # (T,) int32
    startind: int               # column of the number of active components
    specres_at: int             # column of a free resolution, else -1
    cont_at: int                # column of a free continuum, else -1


#: the fields of :class:`CubeTables` with a leading problem axis when stacked
_PER_PROBLEM = ("lo", "hi", "zspan", "inv_wrest_cm", "gamma", "f", "taps",
                "velstep", "contval", "const_term", "cdf4", "cdf5", "grace",
                "gp_mu", "gp_isig2", "gp_norm", "d0", "cw", "data", "ivar",
                "inv_noise")


#: the pointer arguments of csrc/fused_loglike.cu's mcalf_fused_loglike_cube,
#: in its order: the rows, the tables, the problem axis and the output
_CUBE_POINTERS = (("u",) + _PER_PROBLEM[:16] + ("pidx", "u_zidx", "comp_id", "is_fill")
                  + _PER_PROBLEM[16:] + ("tmin", "modes", "prob", "loglike"))


def fused_loglike_cube_plain(u, prob, t: CubeTables, *, half: int,
                             asymm: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_loglike_cube`, on any device:
    the glue the kernel mirrors (``torch_model.loglike_cube_core`` on the
    CPU: the cube transform, ``dz``, ``fused_args``,
    :func:`fused_loglike_plain` and ``loglike_from_fused``) fed the tables
    of ``t``.  With ``prob``, each run of consecutive rows of one problem
    is one call on that problem's tables, as for
    :func:`fused_loglike_plain`."""
    if prob is not None:
        if u.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.float32, device=u.device)
        return torch.cat([
            fused_loglike_cube_plain(
                u[a:b], None,
                t._replace(**{k: getattr(t, k)[q] for k in _PER_PROBLEM
                              if getattr(t, k) is not None}),
                half=half, asymm=asymm)
            for a, b, q in _runs(prob)
        ])
    from mcalf_torch.models import torch_model as tm

    T, P = t.d0.shape[-2:]
    freespecres, freecont = t.specres_at >= 0, t.cont_at >= 0
    # the glue reads a free resolution in column 0 and a free continuum next
    if t.specres_at not in (-1, 0) or freecont and t.cont_at != int(freespecres):
        raise ValueError(f"specres_at {t.specres_at}, cont_at {t.cont_at}: not the glue's "
                         "columns")
    s = tm.StaticSpec(ndim=u.shape[1], npix=P, ntrans=T, startind=t.startind,
                      freecont=freecont, freespecres=freespecres, half=half,
                      conv_mode="same_edge", asymmlike=bool(asymm),
                      has_gpriors=t.gp_mu is not None)
    c = {k: v for k, v in t._asdict().items() if isinstance(v, torch.Tensor)}
    c["c_over_wave"] = c.pop("cw")
    c["fixed_specres"] = None  # a fixed resolution comes as its taps
    p = tm.cube_to_params_core(u, c)
    dz = (u[..., c["u_zidx"]] - 0.5) * c["zspan"]
    chi2, n4, n5 = fused_loglike_plain(*tm.fused_args(p, c, s, dz=dz), half=half,
                                       asymm=s.asymmlike)
    return tm.loglike_from_fused(p, c, s, chi2, n4, n5)


def _check_cube_inputs(u, prob, t: CubeTables, half: int) -> None:
    """What the cube kernel reads: every table contiguous on the rows'
    device in its dtype, per-problem tables with the problem axis exactly
    when ``prob`` is given, and columns inside the parameter vector."""
    B, ndim = u.shape
    T, P = t.d0.shape[-2:]
    lead = () if prob is None else (t.d0.shape[0],)
    K = 2 * half + 1
    if t.taps is None and half > 0 and t.specres_at < 0:
        raise ValueError("taps: None needs a free resolution (specres_at)")
    if (t.gp_mu is None) != (t.gp_isig2 is None) or (t.gp_mu is None) != (t.gp_norm is None):
        raise ValueError("gp_mu, gp_isig2, gp_norm: give all three or none")
    if not all(-1 <= j < ndim for j in (t.specres_at, t.cont_at)) or not 0 <= t.startind < ndim:
        raise ValueError(f"startind {t.startind}, specres_at {t.specres_at}, cont_at "
                         f"{t.cont_at}: outside the {ndim} parameters")
    if K > THREADS:
        raise ValueError(f"{K} LSF taps: the kernel builds at most {THREADS}")
    want = {
        "lo": (ndim,), "hi": (ndim,), "zspan": (T,), "inv_wrest_cm": (T,),
        "gamma": (T,), "f": (T,), "taps": (K,), "velstep": (), "contval": (),
        "const_term": (), "cdf4": (), "cdf5": (), "grace": (), "gp_mu": (ndim,),
        "gp_isig2": (ndim,), "gp_norm": (), "d0": (T, P), "cw": (P,), "data": (P,),
        "ivar": (P,), "inv_noise": (P,),
    }
    named = [("u", u, torch.float32, (B, ndim))]
    named += [(k, getattr(t, k), torch.float32, lead + shape) for k, shape in want.items()]
    named += [("pidx", t.pidx, torch.int64, (T,)), ("u_zidx", t.u_zidx, torch.int64, (T,)),
              ("comp_id", t.comp_id, torch.float32, (T,)),
              ("is_fill", t.is_fill, torch.bool, (T,)),
              ("tmin", t.tmin, torch.float32, (T,)), ("modes", t.modes, torch.int32, (T,))]
    for name, x, dtype, shape in named:
        if x is None:
            continue
        if x.device != u.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor on {u.device}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
    if prob is not None:
        _check_prob(prob, u, t.d0, B)


def fused_loglike_cube(u, prob, t: CubeTables, *, half: int, asymm: bool) -> torch.Tensor:
    """Log-likelihood (B,) float32 of unit-cube rows ``u`` (B, ndim) in one
    launch of the fused kernel: each row's parameters, line tables, LSF taps
    and continuum are made from its point inside the kernel, by the same
    float32 operations as the PyTorch glue of
    ``mcalf_torch.models.torch_model.loglike_cube_core``, and the kernel
    writes -0.5 (chi^2 + const_term), -inf where the asymmlike counts pass
    cdf + grace, less the Gaussian priors' term.

    ``prob``: optional (B,) int32 problem of each row; the per-problem
    tables of ``t`` then have a leading problem axis, and every entry of
    prob must lie in [0, Q) (not checked: that would cost a device read).
    Adds one to :data:`launches` and :data:`cube_launches`, and its rows
    x transitions to :data:`lines`; the card adds the lines that took the
    full ``hjert`` to ``hjert_lines`` and their pixels that took its series
    to ``series_evals``."""
    if u.device.type == "cpu":
        return fused_loglike_cube_plain(u, prob, t, half=half, asymm=asymm)
    if u.device.type != "cuda":
        raise ValueError(f"fused_loglike_cube runs on cpu or cuda, not {u.device}")
    if u.dim() != 2:
        raise ValueError(f"u: shape {tuple(u.shape)}, need (B, ndim)")
    B, ndim = u.shape
    T, P = t.d0.shape[-2:]
    geo = fused_geometry(T, P, half)
    _check_cube_inputs(u, prob, t, half)
    out = torch.empty((B,), dtype=torch.float32, device=u.device)
    if B == 0:
        return out
    rows = {"u": u, "prob": prob, "loglike": out}
    ptrs = [rows[k] if k in rows else getattr(t, k) for k in _CUBE_POINTERS]
    damped = _any_damped(t.modes)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _fused_cube_fn()(
        *(None if x is None else x.data_ptr() for x in ptrs),
        B, T, P, half, geo.tile, geo.cluster, geo.smem, ndim, t.startind,
        t.specres_at, t.cont_at, int(bool(asymm)), int(damped), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_loglike_cube kernel launch failed: CUDA error {err}")
    _counted(u.device, damped)
    count_launch(_fused_counter(True, B, T))
    return out
