"""Dynamic (posterior-focused) nested sampling via run merging.

Port of :mod:`mcalf_tpu.sampler.dynamic`.  The reference offers
dyPolyChord's dynamic live-point allocation: after an exploratory run, live
points are concentrated where the posterior mass lives, improving posterior
resolution per likelihood call.  Higson et al. (2019) showed dynamic NS is
equivalent to MERGING nested-sampling runs whose live points are born at a
likelihood threshold inside the posterior bulk -- which is exactly what the
birth-contour merge in :mod:`mcalf_torch.sampler.merge` computes:

1. run a standard ("base") nested-sampling pass;
2. pick the boost threshold L_init where the cumulative posterior mass
   (from below) crosses ``boost_start_mass`` (dyPolyChord's
   dynamic_goal=1 analogue);
3. draw a fresh live set above L_init: random base samples already above
   the threshold, decorrelated by the same constrained slice engine
   (:func:`mcalf_torch.sampler.nested.slice_chains`);
4. run a second NS pass from that live set (its shrinkage bookkeeping is
   run-local and never used directly);
5. merge both runs by birth contours: the combined run has
   nlive_base + nlive_boost live points across the posterior bulk, i.e.
   denser posterior samples and a sqrt-ish smaller evidence error there.

Both passes and the seeding between them draw from ONE ``torch.Generator``,
in that order, and each pass's checkpointable states carry the generator's
state: a run resumed from its base or boost checkpoints draws what the
uninterrupted run drew.  Threshold selection and the merge run on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mcalf_torch.sampler.merge import MergedRun, merge_results
from mcalf_torch.sampler.nested import (
    NSConfig,
    NSResults,
    NSState,
    nested_sample,
    slice_chains,
)

__all__ = ["DynamicResults", "dynamic_sample", "posterior_ess"]


class DynamicResults(NamedTuple):
    merged: MergedRun
    #: both passes' results as host numpy arrays
    base: NSResults
    boost: NSResults
    #: likelihood threshold the boost run was seeded above
    l_init: float


def posterior_ess(log_posterior_weights) -> float:
    """Kish effective sample size of a weighted posterior sample set."""
    logp = np.asarray(log_posterior_weights, np.float64)
    logp = logp[np.isfinite(logp)]
    if logp.size == 0:
        return 0.0
    w = np.exp(logp - logp.max())
    return float(w.sum() ** 2 / (w**2).sum())


def _choose_l_init(base: NSResults, boost_start_mass: float) -> float:
    """Likelihood value below which ``boost_start_mass`` of the posterior
    mass lies (host-side; ``base`` holds numpy arrays)."""
    logp = np.asarray(base.log_posterior_weights, np.float64)
    logl = np.asarray(base.logl, np.float64)
    valid = np.isfinite(logp)
    logp, logl = logp[valid], logl[valid]
    order = np.argsort(logl)
    w = np.exp(logp[order] - logp.max())
    cum = np.cumsum(w) / w.sum()
    idx = int(np.searchsorted(cum, boost_start_mass))
    idx = min(max(idx, 0), logl.size - 1)
    return float(logl[order][idx])


def _seed_boost_state(
    loglike_batch: Callable,
    gen: torch.Generator,
    base: NSResults,
    l_init: float,
    cfg: NSConfig,
    device: "torch.device | str",
) -> NSState:
    """Build a decorrelated live set above ``l_init`` from base-run samples
    (``base`` holds numpy arrays; ``cfg`` is resolved).

    Base samples above the threshold are each uniform within their own
    (deeper) contour; using them directly would over-weight the deep
    interior.  Starting chains from them and running the full constrained
    slice engine at threshold l_init re-equilibrates toward
    pi(theta | L > l_init) -- the same approximation quality as every NS
    replacement step (dynesty seeds its batch runs the same way).  The pick
    among the base samples comes from the run's generator."""
    cap = int(cfg.max_samples)
    nlive, ndim = cfg.nlive, cfg.ndim
    f32 = torch.float32

    logl = np.asarray(base.logl, np.float64)
    logw = np.asarray(base.logw, np.float64)
    pool = np.flatnonzero(np.isfinite(logw) & (logl > l_init))
    if pool.size < 2:
        raise ValueError(
            f"only {pool.size} base samples above l_init={l_init}; "
            "lower boost_start_mass"
        )
    if pool.size < nlive:  # with replacement
        idx = torch.randint(0, pool.size, (nlive,), generator=gen, device=device)
    else:
        idx = torch.randperm(pool.size, generator=gen, device=device)[:nlive]
    pick = pool[idx.cpu().numpy()]
    u0 = torch.as_tensor(np.asarray(base.samples_u)[pick], dtype=f32, device=device)
    l0 = torch.as_tensor(np.asarray(base.logl)[pick], dtype=f32, device=device)
    lstar = torch.tensor(l_init, dtype=f32, device=device)

    u1, l1, n_evals = slice_chains(loglike_batch, gen, u0, l0, u0, l0, lstar, cfg)

    return NSState(
        live_u=u1,
        live_logl=l1,
        live_birth=lstar.expand(nlive).clone(),
        dead_u=torch.zeros((cap, ndim), dtype=f32, device=device),
        dead_logl=torch.full((cap,), -math.inf, dtype=f32, device=device),
        dead_logw=torch.full((cap,), -math.inf, dtype=f32, device=device),
        dead_birth=torch.full((cap,), math.inf, dtype=f32, device=device),
        n_dead=0,
        logx=torch.tensor(0.0, dtype=f32, device=device),
        logz=torch.tensor(-math.inf, dtype=f32, device=device),
        n_like=n_evals + nlive,
        step=0,
        dead_rank=torch.full((cap,), -1, dtype=torch.int32, device=device),
        live_cluster=torch.zeros((nlive,), dtype=torch.int64, device=device),
    )


def dynamic_sample(
    loglike_batch: Callable,
    gen: torch.Generator,
    config: NSConfig,
    device: "torch.device | str",
    boost_config: Optional[NSConfig] = None,
    boost_start_mass: float = 0.01,
    *,
    base_state: Optional[NSState] = None,
    boost_state: Optional[NSState] = None,
    on_chunk_base: Optional[Callable[[NSState], None]] = None,
    on_chunk_boost: Optional[Callable[[NSState], None]] = None,
) -> DynamicResults:
    """Two-pass dynamic nested sampling (base + posterior boost + merge).

    ``config`` drives the base run; ``boost_config`` (default: same) the
    boost run.  ``boost_start_mass``: the boost live set is seeded at the
    likelihood below which this fraction of the base-run posterior mass
    lies (0.01 reproduces dyPolyChord's posterior-focused dynamic_goal=1
    behavior of covering essentially the whole posterior bulk).

    Checkpoint/resume (dyPolyChord's resume role): both passes run through
    the same chunked :func:`nested_sample`, so each accepts a resume
    ``*_state`` and a per-chunk callback.  Resuming from a TERMINAL base
    state replays the (cheap, deterministic) finalization, puts the
    generator back where the base pass left it and goes straight to the
    boost pass; ``boost_state`` then skips the seeding too.  Threshold
    selection and boost seeding are deterministic functions of (base
    results, generator state), so a resumed run follows the same flow.
    """
    base = nested_sample(
        loglike_batch, gen, config, device, state=base_state, on_chunk=on_chunk_base
    ).numpy()

    l_init = _choose_l_init(base, boost_start_mass)
    bc = (boost_config or config).resolved()
    if boost_state is None:
        boost_state = _seed_boost_state(loglike_batch, gen, base, l_init, bc, device)
    boost = nested_sample(
        loglike_batch, gen, bc, device, state=boost_state, on_chunk=on_chunk_boost
    ).numpy()

    merged = merge_results([base, boost])
    return DynamicResults(merged=merged, base=base, boost=boost, l_init=l_init)
