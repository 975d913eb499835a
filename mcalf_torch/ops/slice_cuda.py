"""The slice sampler's bookkeeping as two CUDA kernels (``csrc/slice_step.cu``).

On a card, one chord-bracket slice iteration of
:func:`mcalf_torch.sampler.nested._slice_step` is :func:`slice_propose`,
the likelihood call on the clamped rows it writes, and :func:`slice_update`,
in place of the about 70 torch ops of ``nested._slice_step_ops``.  Those
stay the one plain definition: the CPU's path, the step-out bracket's, and
the twin the card's tests hold the kernels to, every carry tensor bit for
bit (the bracket ends by value: see the source).  Both wrappers take the
loop's state as plain tensors, Q problems of B chains in ndim: the points
``u`` and directions ``d`` (Q, B, ndim) float32, ``logl``, ``lo``, ``hi``
(Q, B) float32, ``it_pass`` and ``passes`` (Q, B) int32, ``it_total`` ()
int32 and ``n_like`` (Q,) int64; they raise on anything but contiguous
tensors of those dtypes and shapes on one CUDA device.  The kernels launch
on the current stream and allocate nothing.  ``launches`` counts the :func:`slice_update` launches
as the card runs them (:func:`mcalf_torch.utils.profiling.count_launch`: a
launch captured in a CUDA graph counts at each replay).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mcalf_torch.utils.profiling import count_launch

__all__ = ["Scratch", "scratch", "slice_propose", "slice_update", "launches"]

#: number of :func:`slice_update` launches (one per slice iteration)
launches = 0


class Scratch(NamedTuple):
    """What :func:`slice_propose` writes and :func:`slice_update` reads, made
    once for a loop."""

    running: torch.Tensor   # (Q, B) bool: the chain has a pass to make
    t: torch.Tensor         # (Q, B) float32 the proposal along the direction
    inside: torch.Tensor    # (Q, B) bool: the proposal lies in the unit cube
    u_eval: torch.Tensor    # (Q, B, ndim) float32 the proposal, clamped to it


def scratch(Q: int, B: int, ndim: int, device) -> Scratch:
    return Scratch(
        torch.zeros((Q, B), dtype=torch.bool, device=device),
        torch.zeros((Q, B), dtype=torch.float32, device=device),
        torch.zeros((Q, B), dtype=torch.bool, device=device),
        torch.zeros((Q, B, ndim), dtype=torch.float32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _fns():
    """The two C entry points (the library is built at first use)."""
    from mcalf_torch.ops._build import load

    lib = load().lib
    propose, update = lib.mcalf_slice_propose, lib.mcalf_slice_update
    propose.restype = update.restype = ctypes.c_int
    # 12 pointers, Q, B, ndim, nrep, total_cap, stream
    propose.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    # 15 pointers (active may be null), Q, B, ndim, nrep, max_shrink, stream
    update.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return propose, update


def _dims(u: torch.Tensor):
    if u.dim() != 3:
        raise ValueError(f"u: shape {tuple(u.shape)}, need (Q, B, ndim)")
    return tuple(u.shape)


def _scratch(s: Scratch, Q: int, B: int, ndim: int):
    return [("running", s.running, torch.bool, (Q, B)), ("t", s.t, torch.float32, (Q, B)),
            ("inside", s.inside, torch.bool, (Q, B)),
            ("u_eval", s.u_eval, torch.float32, (Q, B, ndim))]


def _check(named, device) -> None:
    """Every named tensor contiguous on ``device`` in its dtype and shape."""
    for name, x, dtype, shape in named:
        if x is None:
            continue
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor on {device}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")


def _check_propose(u, d, lo, hi, passes, it_total, n_like, r, s: Scratch) -> None:
    Q, B, ndim = _dims(u)
    f32, i32 = torch.float32, torch.int32
    _check([("u", u, f32, (Q, B, ndim)), ("d", d, f32, (Q, B, ndim)), ("lo", lo, f32, (Q, B)),
            ("hi", hi, f32, (Q, B)), ("passes", passes, i32, (Q, B)),
            ("it_total", it_total, i32, ()), ("n_like", n_like, torch.int64, (Q,)),
            ("r", r, f32, (Q, B))] + _scratch(s, Q, B, ndim), u.device)


def _check_update(u, logl, d, lo, hi, it_pass, passes, it_total, active, pools, lstar, ll,
                  s: Scratch) -> None:
    Q, B, ndim = _dims(u)
    if pools.dim() != 4:
        raise ValueError(f"pools: shape {tuple(pools.shape)}, need (Q, num_repeats, B, ndim)")
    f32, i32 = torch.float32, torch.int32
    _check([("u", u, f32, (Q, B, ndim)), ("logl", logl, f32, (Q, B)),
            ("d", d, f32, (Q, B, ndim)), ("lo", lo, f32, (Q, B)), ("hi", hi, f32, (Q, B)),
            ("it_pass", it_pass, i32, (Q, B)), ("passes", passes, i32, (Q, B)),
            ("it_total", it_total, i32, ()), ("active", active, torch.int64, (Q, B)),
            ("pools", pools, f32, (Q, pools.shape[1], B, ndim)),
            ("lstar", lstar, f32, (Q, 1)), ("ll", ll, f32, (Q, B))]
           + _scratch(s, Q, B, ndim), u.device)


def _stream(u: torch.Tensor):
    if u.device.type != "cuda":
        raise ValueError(f"the slice kernels run on cuda, not {u.device} (the "
                         "torch ops of nested._slice_step_ops run everywhere)")
    return torch.cuda.current_stream(u.device).cuda_stream


def slice_propose(u, d, lo, hi, passes, it_total, n_like, r, s: Scratch, *, nrep: int,
                  total_cap: int) -> None:
    """Into ``s``, each chain's proposal of this iteration from its point
    ``u``, direction ``d``, bracket ``lo``/``hi`` and the iteration's
    uniform draws ``r`` (Q, B): whether it has a pass to make (its
    ``passes`` below ``nrep`` and the loop's ``it_total`` below
    ``total_cap``), ``t = lo + r (hi - lo)``, whether ``u + t d`` lies in
    the unit cube, and that point clamped to it; and ``n_like`` adds B for
    each problem with a running chain (the rows this iteration's likelihood
    call evaluates for it)."""
    stream = _stream(u)
    _check_propose(u, d, lo, hi, passes, it_total, n_like, r, s)
    Q, B, ndim = u.shape
    err = _fns()[0](
        *(x.data_ptr() for x in (u, d, lo, hi, passes, it_total, r, s.running, s.t,
                                 s.inside, s.u_eval, n_like)),
        Q, B, ndim, nrep, total_cap, stream,
    )
    if err != 0:
        raise RuntimeError(f"slice_propose kernel launch failed: CUDA error {err}")


def slice_update(u, logl, d, lo, hi, it_pass, passes, it_total, active, pools, lstar, ll,
                 s: Scratch, *, max_shrink: int) -> None:
    """The rest of the iteration in place on the chains' state, from the
    likelihood ``ll`` (Q, B) of ``s.u_eval``: accept where the proposal lies
    in the cube with log L above ``lstar`` (Q, 1) (``u``, ``logl``), else
    shrink the bracket toward the current point; a chain that accepted or
    made ``max_shrink`` proposals (``it_pass``) starts its next pass
    (``passes``) along its next direction of ``pools`` (Q, num_repeats, B,
    ndim) with that direction's cube chord (``d``, ``lo``, ``hi``);
    ``it_total`` adds one, and ``active`` (Q, B) int64, unless None, the
    running chains."""
    stream = _stream(u)
    _check_update(u, logl, d, lo, hi, it_pass, passes, it_total, active, pools, lstar, ll, s)
    Q, B, ndim = u.shape
    err = _fns()[1](
        *(x.data_ptr() for x in (u, logl, d, lo, hi, it_pass, passes, it_total)),
        None if active is None else active.data_ptr(),
        *(x.data_ptr() for x in (pools, lstar, ll, s.running, s.t, s.inside)),
        Q, B, ndim, pools.shape[1], max_shrink, stream,
    )
    if err != 0:
        raise RuntimeError(f"slice_update kernel launch failed: CUDA error {err}")
    count_launch(_add_launches)


def _add_launches(n: int) -> None:
    global launches
    launches += n
