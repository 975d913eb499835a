"""Automatic num_repeats escalation: evidence you can trust without
hand-tuning the decorrelation length.

Port of :mod:`mcalf_tpu.sampler.repeats`.  ``num_repeats`` (the
slice-sampling decorrelation length, PolyChord's knob of the same name) is
the one sampler setting with no universally safe default: too few passes
under-mix the replacement chains and bias logZ low by *nats* while every
per-run indicator can still look healthy (the insertion-rank test is
necessary, not sufficient -- the JAX package's flagship study measured
seed-to-seed scatter 2-7x the quoted logzerr at low repeats with green rank
tests, tools/flagship_study_r03.jsonl).  The reliable procedure is the
REPEATS LADDER used to validate the flagship evidence: fit at num_repeats,
double it, and accept only when successive rungs agree within the quoted
error.

:func:`converged_sample` automates exactly that ladder:

1. fit ``seeds`` independent seeds at the starting ``num_repeats``;
2. double ``num_repeats`` and refit;
3. stop when the two rungs' mean logZ agree within ``tol_sigma`` x the
   combined uncertainty of the comparison -- where the uncertainty uses
   the MEASURED cross-seed scatter when it exceeds the quoted
   sqrt(H/nlive) error (under-mixing shows up as excess scatter long
   before it shows up in the quoted error) -- and every run's
   insertion-rank test is green;
4. return the final rung's seeds merged by birth contours
   (:mod:`mcalf_torch.sampler.merge`), plus the full ladder for reporting.

Cost: a geometric ladder sums to < 2x the final rung, so the price of the
guarantee is bounded at about 2x a single (correctly tuned) fit.  Exposed
on the CLI as ``[ns_settings] auto_repeats`` (mcalf_torch.runner).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from mcalf_torch.sampler.diagnostics import insertion_rank_test
from mcalf_torch.sampler.merge import MergedRun, merge_results
from mcalf_torch.sampler.nested import NSConfig, NSResults, nested_sample

__all__ = ["LadderRung", "ConvergedRun", "converged_sample"]


class LadderRung(NamedTuple):
    num_repeats: int
    logz_seeds: List[float]          # per-seed logZ
    logzerr: float                   # mean quoted per-run sqrt(H/nlive)
    scatter: float                   # cross-seed sample std (0 if 1 seed)
    rank_p: List[float]              # per-seed insertion-rank p-values
    n_like: int                      # total likelihood evals at this rung


class ConvergedRun(NamedTuple):
    merged: MergedRun                # final rung's seeds, birth-merged
    results: List[NSResults]         # final rung's per-seed results (numpy)
    ladder: List[LadderRung]
    converged: bool                  # doubling criterion met (False = the
    #                                  max_doublings budget ran out first)
    num_repeats: int                 # final rung's value


def _rung_uncertainty(rung: LadderRung) -> float:
    """Uncertainty of a rung's mean logZ: the quoted error of the mean, or
    the measured cross-seed standard error when scatter exceeds it."""
    n = max(len(rung.logz_seeds), 1)
    quoted = rung.logzerr / np.sqrt(n)
    measured = rung.scatter / np.sqrt(n) if n > 1 else 0.0
    return float(max(quoted, measured))


def _rung_generator(seed: int, rung: int, index: int, device) -> torch.Generator:
    """The generator of run ``index`` at ladder rung ``rung``: its own
    stream, seeded from (seed, rung, index) and from nothing else."""
    word = np.random.SeedSequence([int(seed), int(rung), int(index)]).generate_state(
        1, np.uint64
    )[0]
    return torch.Generator(device=device).manual_seed(int(word) & (2**63 - 1))


def converged_sample(
    loglike_batch: Callable,
    seed: int,
    config: NSConfig,
    device: "torch.device | str",
    *,
    seeds: int = 2,
    max_doublings: int = 4,
    tol_sigma: float = 1.0,
    rank_p_min: float = 0.01,
    verbose: bool = False,
    on_chunk: Optional[Callable] = None,
) -> ConvergedRun:
    """Run the repeats ladder until one doubling of ``num_repeats`` moves
    the mean logZ by less than ``tol_sigma`` combined uncertainties.

    Parameters
    ----------
    loglike_batch : batched unit-cube log-likelihood (as nested_sample).
    seed : integer; every run of every rung gets its own generator on
        ``device``, seeded from (seed, rung, index).
    config : base NSConfig; its (resolved) num_repeats is the FIRST rung.
    device : where the runs live (as nested_sample).
    seeds : independent fits per rung (>= 2 recommended -- cross-seed
        scatter is the under-mixing detector the quoted error misses).
    max_doublings : ladder budget above the first rung.
    tol_sigma : acceptance threshold in combined-uncertainty units for the
        |mean_k - mean_{k-1}| doubling test.
    rank_p_min : every run of both compared rungs must pass the
        insertion-rank test at this level (calibrated kappa, see
        sampler/diagnostics.py).
    on_chunk : forwarded to :func:`nested_sample` (progress reporting).

    Returns :class:`ConvergedRun`; ``converged=False`` means the budget was
    exhausted before the criterion held -- the caller should treat the
    evidence as a lower-confidence estimate (the CLI prints a WARNING).
    """
    cfg0 = config.resolved()
    rungs: List[LadderRung] = []
    rung_results: List[List[NSResults]] = []
    nr = cfg0.num_repeats
    for k in range(max_doublings + 1):
        cfg = dataclasses.replace(cfg0, num_repeats=nr)
        results, lzs, ps = [], [], []
        for s in range(seeds):
            gen = _rung_generator(seed, k, s, device)
            res = nested_sample(
                loglike_batch, gen, cfg, device, on_chunk=on_chunk
            ).numpy()
            results.append(res)
            lzs.append(float(res.logz))
            ps.append(insertion_rank_test(res, cfg).p_value)
        rung = LadderRung(
            num_repeats=nr,
            logz_seeds=[round(v, 3) for v in lzs],
            logzerr=float(np.mean([float(r.logzerr) for r in results])),
            scatter=float(np.std(lzs, ddof=1)) if len(lzs) > 1 else 0.0,
            rank_p=[round(p, 5) for p in ps],
            n_like=int(sum(int(r.n_like) for r in results)),
        )
        rungs.append(rung)
        rung_results.append(results)
        if verbose:
            print(
                f"  ladder num_repeats={nr}: logZ={rung.logz_seeds} "
                f"(quoted err {rung.logzerr:.3f}, scatter "
                f"{rung.scatter:.3f}), rank p={rung.rank_p}"
            )
        if k > 0:
            prev = rungs[-2]
            shift = abs(
                float(np.mean(rung.logz_seeds))
                - float(np.mean(prev.logz_seeds))
            )
            tol = tol_sigma * float(
                np.hypot(_rung_uncertainty(rung), _rung_uncertainty(prev))
            )
            ranks_ok = all(
                p > rank_p_min for p in rung.rank_p + prev.rank_p
            )
            if shift <= tol and ranks_ok:
                return ConvergedRun(
                    merged=merge_results(rung_results[-1]),
                    results=rung_results[-1],
                    ladder=rungs,
                    converged=True,
                    num_repeats=nr,
                )
        nr *= 2
    return ConvergedRun(
        merged=merge_results(rung_results[-1]),
        results=rung_results[-1],
        ladder=rungs,
        converged=False,
        num_repeats=rungs[-1].num_repeats,
    )
