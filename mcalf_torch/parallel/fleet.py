"""Fits of several independent problems together: on one card, and across
processes through ``torch.distributed``.

Port of :mod:`mcalf_tpu.parallel.fleet`.  The JAX package stacks
independent problems -- sightlines, candidate models, seeds of one problem
-- on a leading axis and shards that axis over a device mesh.  On one card
the counterpart of "shard the problem axis" is "carry the problem axis
through the sampler and the kernel": the problems' slice chains run stacked
(:func:`mcalf_torch.sampler.nested.nested_sample_stacked`), and each slice
iteration evaluates the rows of every running problem in one kernel launch
(:class:`~mcalf_torch.models.torch_model.StackedForward`: the fused kernel
in ``conv_mode='same_edge'``, the tau kernel in ``'wrap'`` and ``'same'``).  Each
problem keeps its own generator, termination and chunk schedule, so problem
i ends bit for bit where ``nested_sample`` alone takes it with generator i.

Across cards (or processes) the mesh is a list of (rank, device) entries
(:func:`make_mesh`): the problem axis is split into one contiguous block per
entry, each process fits the blocks of its own entries as such fleets, and
the blocks' results are gathered to every process.  The fits exchange
nothing while they run (the JAX docstring's "no collectives inside the hot
loop"): only the final results cross between processes, and they go to
host files anyway, so the process group is ``gloo`` over host copies, not
NCCL (which also refuses two ranks on one card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mcalf_torch.models.batched import STATIC_KEYS, stack_problems
from mcalf_torch.models.forward import AbsorptionModel
from mcalf_torch.models.torch_model import StaticSpec, make_stacked_forward
from mcalf_torch.sampler.nested import (
    _COUNTERS,
    NSConfig,
    NSResults,
    NSState,
    finalize,
    nested_sample_stacked,
    stack_results,
    stack_states,
    unstack_states,
)

__all__ = ["MeshEntry", "init_distributed", "make_mesh", "fit_many", "fit_stacked"]

#: how long a process waits for the others (the gather of the results
#: waits for the slowest block's whole fit)
PROCESS_GROUP_TIMEOUT = datetime.timedelta(hours=12)

#: this process's device, set by :func:`init_distributed`
_process_device: Optional[torch.device] = None


class MeshEntry(NamedTuple):
    """One block of a mesh: the process (``torch.distributed`` rank, 0
    without a process group) and the device it fits that block on."""

    rank: int
    device: torch.device


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: str = "gloo",
) -> int:
    """Join the processes of a fleet and return their number (the
    counterpart of ``jax.distributed.initialize``).

    ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` (host:port) with world size
    ``num_processes`` and rank ``process_id``; where these are None they
    come from the environment ``torchrun`` sets (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The group is ``gloo``: the
    fits exchange only their final results, on the host (see the module's
    docstring).

    This process's device: ``local_device_ids[0]`` (a CUDA ordinal, or
    ``"cpu"`` to ask for the CPU), else card ``LOCAL_RANK % device_count``;
    without a card and without ``"cpu"`` it raises.  :func:`make_mesh` then
    builds the mesh of every process's device.  A second call raises."""
    import torch.distributed as dist

    global _process_device
    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is already initialised")
    want = None if not local_device_ids else local_device_ids[0]
    if want == "cpu" or (isinstance(want, torch.device) and want.type == "cpu"):
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: torch finds no CUDA device; pass "
            "local_device_ids=['cpu'] to fit on the CPU"
        )
    else:
        idx = (torch.device("cuda", want).index if want is not None
               else int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.set_device(idx)
        device = torch.device("cuda", idx)
    if coordinator_address is None and num_processes is None and process_id is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=PROCESS_GROUP_TIMEOUT)
    else:
        addr = coordinator_address or (
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}",
            world_size=int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes),
            rank=int(os.environ["RANK"] if process_id is None else process_id),
            timeout=PROCESS_GROUP_TIMEOUT,
        )
    _process_device = device
    return dist.get_world_size()


def make_mesh(devices=None) -> List[MeshEntry]:
    """The mesh a fleet runs on, as (rank, device) entries.

    Without a process group: the given devices, or the current CUDA device
    (raises when there is none; pass ``["cpu"]`` for the CPU), all rank 0.
    With a process group (:func:`init_distributed`), every process calls
    it (it gathers): one entry per process holding that process's device,
    or, where ``devices`` are given, one entry per device given in each
    process, rank by rank."""
    if devices is None and _world() > 1:
        devices = [_process_device or torch.device("cuda", torch.cuda.current_device())]
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch finds no CUDA device; pass devices=['cpu'] "
                "to fit on the CPU"
            )
        devices = [torch.device("cuda", torch.cuda.current_device())]
    mine = [str(torch.device(d)) for d in devices]
    if _world() == 1:
        return [MeshEntry(0, torch.device(d)) for d in mine]
    import torch.distributed as dist

    every = [None] * _world()
    dist.all_gather_object(every, mine)
    return [MeshEntry(r, torch.device(d)) for r, ds in enumerate(every) for d in ds]


def _as_mesh(mesh) -> List[MeshEntry]:
    """``mesh`` as entries: a list of devices is this process's own."""
    if mesh is None:
        return make_mesh()
    return [m if isinstance(m, MeshEntry) else MeshEntry(_rank(), torch.device(m))
            for m in mesh]


def _default_generators(seed: int, nprob: int, device) -> list:
    """One ``torch.Generator`` per problem on ``device``: problem i's is
    seeded with the first 64-bit word of
    ``numpy.random.SeedSequence(seed).spawn(nprob)[i]``."""
    return [
        torch.Generator(device=device).manual_seed(int(c.generate_state(1, np.uint64)[0]))
        for c in np.random.SeedSequence(seed).spawn(nprob)
    ]


def _slice_problems(stacked: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    return {k: v if k in STATIC_KEYS else v[lo:hi] for k, v in stacked.items()}


def _slice_state(states: NSState, lo: int, hi: int) -> NSState:
    return NSState(**{
        f: None if v is None else (v[lo:hi] if f not in _COUNTERS
                                   else tuple(v[lo:hi]))
        for f, v in states._asdict().items()
    })


def fit_stacked(
    spec: StaticSpec,
    stacked: Dict[str, Any],
    config: NSConfig,
    seed: int = 43,
    mesh: Optional[list] = None,
    chunk_steps: Optional[int] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
    states: Optional[NSState] = None,
    on_chunk: Optional[Callable[..., None]] = None,
) -> NSResults:
    """Run one independent nested-sampling fit per stacked problem
    (:func:`~mcalf_torch.models.batched.stack_problems`'s output) and
    return :class:`NSResults` with a leading problem axis (tensors on the
    device, integer fields as numpy arrays).

    ``generators``: one ``torch.Generator`` per problem, every problem's
    given to every process (e.g. ``manual_seed(s)`` for each seed of a seed
    ensemble: then problem i is bit for bit the solo fit with that seed);
    by default problem i's is seeded with the first 64-bit word of
    ``numpy.random.SeedSequence(seed).spawn(nprob)[i]`` in every process.
    Either way problem i does not depend on the mesh.

    ``mesh``: a list of devices (this process's), or :func:`make_mesh`'s
    entries; the number of problems must be a multiple of its size.  The
    problem axis is split into one contiguous block per entry; each
    process fits the blocks of its entries, one host thread per entry
    where it holds several, each block as one fleet on its device; the
    blocks are gathered (``all_gather_object`` of host copies where the
    mesh spans processes), and every process returns the full stacked
    results.

    ``chunk_steps``: outer steps between the chunk boundaries at which the
    host re-clusters each problem's live set and may save the fleet (the
    default is :func:`~mcalf_torch.sampler.nested.nested_sample`'s
    schedule).  ``states`` resumes from a stacked sampler state -- the full
    one, or the blocks of this process's entries -- as ``on_chunk`` hands it
    out and ``utils.checkpoint.save_state``/``load_state`` round-trip, each
    problem's generator state in it, so a killed fleet restarts and ends
    bit for bit as the uninterrupted one.  ``on_chunk(states)`` is called
    with a block's stacked state whenever none of its problems is inside a
    chunk; on a mesh of several entries as ``on_chunk(states, problems)``,
    ``problems`` the block's global indices.  Unlike the JAX package's
    chunks, which run in lock-step over the whole mesh, each block keeps
    its own schedule: no collective runs at a chunk boundary."""
    mesh = _as_mesh(mesh)
    nprob = next(v.shape[0] for k, v in stacked.items() if k not in STATIC_KEYS)
    if nprob % len(mesh) != 0:
        raise ValueError(
            f"number of problems ({nprob}) must be a multiple of mesh size ({len(mesh)})"
        )
    if generators is not None and len(generators) != nprob:
        raise ValueError(f"{len(generators)} generators for {nprob} problems")
    cfg = config.resolved()
    per = nprob // len(mesh)
    rank = _rank()
    mine = [b for b, e in enumerate(mesh) if e.rank == rank]
    if states is not None:
        have = states.live_u.shape[0]
        if have == nprob:
            first = 0
        elif have == per * len(mine):
            first = mine[0] * per
        else:
            raise ValueError(
                f"states hold {have} problems: expected all {nprob} or this "
                f"process's {per * len(mine)}"
            )

    def fit_block(b: int) -> NSResults:
        lo, hi = b * per, (b + 1) * per
        device = mesh[b].device
        gens = (list(generators[lo:hi]) if generators is not None
                else _default_generators(seed, nprob, device)[lo:hi])
        block_states = None
        if states is not None:
            block_states = unstack_states(_slice_state(states, lo - first, hi - first))
        callback = None
        if on_chunk is not None:
            if len(mesh) == 1:
                callback = lambda sts: on_chunk(stack_states(sts))
            else:
                callback = lambda sts: on_chunk(stack_states(sts), range(lo, hi))
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            fwd = make_stacked_forward(spec, _slice_problems(stacked, lo, hi), device)
            finals = nested_sample_stacked(
                fwd.loglike_cube, gens, cfg, device, states=block_states,
                chunk_steps=chunk_steps, on_chunk=callback,
            )
            return stack_results([finalize(s, cfg) for s in finals])

    if len(mine) <= 1:
        results = {b: fit_block(b) for b in mine}
    else:
        with ThreadPoolExecutor(max_workers=len(mine)) as pool:
            results = dict(zip(mine, pool.map(fit_block, mine)))
    if len(results) == len(mesh):
        return _concat([results[b] for b in range(len(mesh))])
    import torch.distributed as dist

    every = [None] * _world()
    dist.all_gather_object(every, {b: r.numpy() for b, r in results.items()})
    blocks = {b: r for part in every for b, r in part.items()}
    here = mesh[mine[0]].device if mine else torch.device("cpu")
    return _concat([
        results[b] if b in results else _to_device(blocks[b], here)
        for b in range(len(mesh))
    ])


_COUNT_FIELDS = ("n_dead", "n_like", "n_iter", "termination_reason")


def _to_device(res: NSResults, device) -> NSResults:
    """Stacked results of host numpy arrays as tensors on ``device`` (the
    integer fields stay numpy arrays, as :func:`stack_results` makes them)."""
    return NSResults(**{
        f: x if f in _COUNT_FIELDS else torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for f, x in res._asdict().items()
    })


def _concat(blocks: Sequence[NSResults]) -> NSResults:
    """Stacked blocks' results along the problem axis, on the first
    block's device."""
    dev = next(x.device for x in blocks[0] if torch.is_tensor(x))
    return NSResults(*(
        torch.cat([v.to(dev) for v in vals]) if torch.is_tensor(vals[0])
        else np.concatenate(vals)
        for vals in zip(*blocks)
    ))


def fit_many(
    models: Sequence[AbsorptionModel],
    config: NSConfig,
    seed: int = 43,
    mesh: Optional[list] = None,
    conv_mode: str = "same_edge",
    chunk_steps: Optional[int] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
    states: Optional[NSState] = None,
    on_chunk: Optional[Callable[..., None]] = None,
    gpriors: bool = False,
) -> NSResults:
    """Fit a list of structurally identical problems together (see
    :func:`fit_stacked`); the label-symmetry gauge fixing applies when every
    problem shares one layout, as in :func:`mcalf_torch.runner.run_fit`."""
    spec, stacked = stack_problems(models, conv_mode=conv_mode, gpriors=gpriors)
    layouts = {m.canon_layout() for m in models}
    if config.canon_layout is None and len(layouts) == 1:
        layout = layouts.pop()
        if layout is not None:
            config = dataclasses.replace(config, canon_layout=layout)
    return fit_stacked(
        spec, stacked, config, seed=seed, mesh=mesh, chunk_steps=chunk_steps,
        generators=generators, states=states, on_chunk=on_chunk,
    )
