"""Sampler-state checkpoint / resume.

Port of :mod:`mcalf_tpu.utils.checkpoint`: the nested sampler's state
(:class:`mcalf_torch.sampler.nested.NSState`) is saved as one ``.npz`` per
checkpoint, under the JAX package's field names, so a checkpoint written by
``mcalf_tpu.utils.checkpoint.save_state`` loads here (its PRNG ``key`` is
dropped: such a state carries no generator state and continues on whatever
generator the caller passes).

The port's own checkpoints also hold ``rng``, the run's ``torch.Generator``
state at the chunk boundary, so a resumed run draws the numbers the
uninterrupted run would have drawn.  A fleet's state
(:func:`mcalf_torch.sampler.nested.stack_states`: a leading problem axis,
the counters as tuples, ``rng`` one row per problem's generator) is saved
and loaded by the same two functions.  A CPU generator's state and a CUDA
generator's are different things: the fingerprint records the generator's
device type, and a checkpoint written on one is refused on the other.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from mcalf_torch.sampler.nested import NSState, nsstate_from_numpy, nsstate_to_numpy

__all__ = [
    "save_state",
    "load_state",
    "latest_checkpoint",
    "prune_checkpoints",
    "problem_fingerprint",
]

_FP_PREFIX = "_fp_"
#: filled with their ``init_state`` defaults when a checkpoint lacks them
_BACKFILLED = ("dead_rank", "live_cluster")
#: absent from a JAX checkpoint, and from a state taken inside a chunk
_OPTIONAL = ("rng",)

Fingerprint = Dict[str, Union[int, float, str]]


def _device(device) -> torch.device:
    """``device``, or the current CUDA device when None (raising without
    one: nothing moves to the CPU unless the caller asks for it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device given and torch finds no CUDA GPU: pass device=\"cpu\" "
            "to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def problem_fingerprint(
    model, cfg, seed: int, device: "torch.device | str | None" = None
) -> Fingerprint:
    """Fingerprint of (problem, sampler config, seed, generator device type),
    so that a resumed checkpoint provably belongs to the current run.
    Hashes the spectrum data and prior bounds; records the sampler's shape
    parameters.  The keys of the JAX package's fingerprint, and
    ``rng_device``: the type of ``device``, the current CUDA device when
    None (which raises without a card)."""
    h = hashlib.sha256()
    for arr in (model.wave, model.flux, model.noise, model.bounds):
        h.update(np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes())
    r = cfg.resolved() if hasattr(cfg, "resolved") else cfg
    return {
        "ndim": int(r.ndim),
        "nlive": int(r.nlive),
        "num_delete": int(r.num_delete),
        "num_repeats": int(r.num_repeats),
        "max_samples": int(r.max_samples),
        "seed": int(seed),
        "data_hash": h.hexdigest(),
        "rng_device": _device(device).type,
    }


def save_state(
    path: str, state: NSState, fingerprint: Optional[Fingerprint] = None
) -> None:
    """Save a sampler state (plus an optional run fingerprint) to ``path``
    (.npz), atomically: the file appears under its name only when whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = nsstate_to_numpy(state)
    for k, v in (fingerprint or {}).items():
        arrays[_FP_PREFIX + k] = np.asarray(v)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz to the name it writes.
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_state(
    path: str,
    fingerprint: Optional[Fingerprint] = None,
    device: "torch.device | str | None" = None,
) -> NSState:
    """Load a sampler state saved by :func:`save_state` (the port's or the
    JAX package's) onto ``device``: the current CUDA device when None
    (which raises without a card; ``device="cpu"`` loads onto the CPU).

    When ``fingerprint`` is given, the checkpoint must carry a matching
    one: resuming a checkpoint of a different problem, sampler config, seed
    or generator device type silently gives wrong posteriors whenever the
    array shapes happen to coincide, so a mismatch raises instead."""
    device = _device(device)
    with np.load(path) as z:
        required = [f for f in NSState._fields if f not in _OPTIONAL]
        hard_missing = [f for f in required if f not in z and f not in _BACKFILLED]
        if hard_missing:
            raise ValueError(f"checkpoint {path!r} missing fields {hard_missing}")
        if fingerprint is not None:
            for k, v in fingerprint.items():
                key = _FP_PREFIX + k
                if key not in z:
                    raise ValueError(
                        f"checkpoint {path!r} has no fingerprint field {k!r}; "
                        "refusing to resume (pass fingerprint=None to force)"
                    )
                have = z[key].item()
                if str(have) != str(v):
                    raise ValueError(
                        f"checkpoint {path!r} fingerprint mismatch on {k!r}: "
                        f"checkpoint has {have!r}, current run has {v!r}"
                        + (
                            " (a checkpoint holds its generator's state, which "
                            "continues only on the device type it was written on)"
                            if k == "rng_device" else ""
                        )
                    )
        fields = {f: z[f] for f in NSState._fields if f in z}
    # Fields a checkpoint may lack get their init_state() defaults, so fits
    # in flight survive an upgrade: dead_rank is diagnostic (-1 = unrecorded).
    if "dead_rank" not in fields:
        fields["dead_rank"] = np.full(fields["dead_logl"].shape, -1, np.int32)
    if "live_cluster" not in fields:
        fields["live_cluster"] = np.zeros(fields["live_logl"].shape, np.int32)
    return nsstate_from_numpy(fields, device)


def _checkpoints(directory: str, prefix: str):
    """The directory's ``<prefix>*.npz`` files, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        (
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.startswith(prefix) and f.endswith(".npz")
        ),
        # written in one tick of the clock: the name's step number decides
        key=lambda p: (os.path.getmtime(p), p),
    )


def latest_checkpoint(directory: str, prefix: str = "ns_state") -> Optional[str]:
    """Most recent checkpoint file in ``directory`` matching
    ``<prefix>*.npz``, or None."""
    cands = _checkpoints(directory, prefix)
    return cands[-1] if cands else None


def prune_checkpoints(
    directory: str, keep: int = 3, prefix: str = "ns_state"
) -> None:
    """Delete all but the ``keep`` most recent checkpoints in ``directory``
    (long fits otherwise accumulate one file per chunk, unbounded)."""
    cands = _checkpoints(directory, prefix)
    for p in cands[: max(0, len(cands) - keep)]:
        try:
            os.remove(p)
        except OSError:
            pass
