"""Fits of several independent problems together on one card.

Port of :mod:`mcalf_tpu.parallel.fleet` for one CUDA device.  The JAX
package stacks independent problems -- sightlines, candidate models, seeds
of one problem -- on a leading axis and shards that axis over a device
mesh.  On one card the counterpart of "shard the problem axis" is "carry
the problem axis through the sampler and the kernel": the problems' slice
chains run stacked (:func:`mcalf_torch.sampler.nested.nested_sample_stacked`),
and each slice iteration evaluates the rows of every running problem in one
fused-kernel launch (:class:`~mcalf_torch.models.torch_model.StackedForward`).
Each problem keeps its own generator, termination and chunk schedule, so
problem i ends bit for bit where ``nested_sample`` alone takes it with
generator i.

The multi-card half (``init_distributed``, and a mesh of several cards
through ``torch.distributed``) is not ported: a mesh here holds one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mcalf_torch.models.batched import STATIC_KEYS, stack_problems
from mcalf_torch.models.forward import AbsorptionModel
from mcalf_torch.models.torch_model import StaticSpec, make_stacked_forward
from mcalf_torch.sampler.nested import (
    NSConfig,
    NSResults,
    NSState,
    finalize,
    nested_sample_stacked,
    stack_results,
    stack_states,
    unstack_states,
)

__all__ = ["make_mesh", "fit_many", "fit_stacked"]


def make_mesh(devices=None) -> list:
    """The devices a fleet runs on: the given ones, or the current CUDA
    device (raises when there is none; pass ``["cpu"]`` for the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch finds no CUDA device; pass devices=['cpu'] "
                "to fit on the CPU"
            )
        devices = [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device(d) for d in devices]


def _default_generators(seed: int, nprob: int, device) -> list:
    """One ``torch.Generator`` per problem on ``device``: problem i's is
    seeded with the first 64-bit word of
    ``numpy.random.SeedSequence(seed).spawn(nprob)[i]``."""
    return [
        torch.Generator(device=device).manual_seed(int(c.generate_state(1, np.uint64)[0]))
        for c in np.random.SeedSequence(seed).spawn(nprob)
    ]


def fit_stacked(
    spec: StaticSpec,
    stacked: Dict[str, Any],
    config: NSConfig,
    seed: int = 43,
    mesh: Optional[list] = None,
    chunk_steps: Optional[int] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
    states: Optional[NSState] = None,
    on_chunk: Optional[Callable[[NSState], None]] = None,
) -> NSResults:
    """Run one independent nested-sampling fit per stacked problem
    (:func:`~mcalf_torch.models.batched.stack_problems`'s output) and
    return :class:`NSResults` with a leading problem axis (tensors on the
    device, integer fields as numpy arrays).

    ``generators``: one ``torch.Generator`` per problem on the mesh's device
    (e.g. ``manual_seed(s)`` for each seed of a seed ensemble: then problem
    i is bit for bit the solo fit with that seed); by default
    problem i's is seeded with the first 64-bit word of
    ``numpy.random.SeedSequence(seed).spawn(nprob)[i]``.

    The number of problems must be a multiple of the mesh size; a mesh of
    one device takes any number.

    ``chunk_steps``: outer steps between the chunk boundaries at which the
    host re-clusters each problem's live set and may save the fleet (the
    default is :func:`~mcalf_torch.sampler.nested.nested_sample`'s
    schedule).  ``states`` resumes from a stacked sampler state -- what
    ``on_chunk(states)`` is handed after every chunk, and what
    ``utils.checkpoint.save_state``/``load_state`` round-trip, each
    problem's generator state in it -- so a killed fleet restarts and ends
    bit for bit as the uninterrupted one."""
    mesh = make_mesh() if mesh is None else make_mesh(mesh)
    nprob = next(v.shape[0] for k, v in stacked.items() if k not in STATIC_KEYS)
    if nprob % len(mesh) != 0:
        raise ValueError(
            f"number of problems ({nprob}) must be a multiple of mesh size ({len(mesh)})"
        )
    if len(mesh) > 1:
        raise NotImplementedError(
            "a fleet over several cards (torch.distributed) is not ported; "
            "ROADMAP Queue 1 item 6"
        )
    device = mesh[0]
    cfg = config.resolved()
    fwd = make_stacked_forward(spec, stacked, device)
    if generators is None:
        generators = _default_generators(seed, nprob, device)
    if len(generators) != nprob:
        raise ValueError(f"{len(generators)} generators for {nprob} problems")
    finals = nested_sample_stacked(
        fwd.loglike_cube, list(generators), cfg, device,
        states=None if states is None else unstack_states(states),
        chunk_steps=chunk_steps,
        on_chunk=None if on_chunk is None else (lambda sts: on_chunk(stack_states(sts))),
    )
    return stack_results([finalize(s, cfg) for s in finals])


def fit_many(
    models: Sequence[AbsorptionModel],
    config: NSConfig,
    seed: int = 43,
    mesh: Optional[list] = None,
    conv_mode: str = "same_edge",
    chunk_steps: Optional[int] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
    states: Optional[NSState] = None,
    on_chunk: Optional[Callable[[NSState], None]] = None,
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
