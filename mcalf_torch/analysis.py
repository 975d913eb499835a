"""Chain analysis: evidence readout, per-sample component z-sorting, parameter
names, and summary statistics.

Replaces the reference's module-level ``pc_analyzer``/``get_parnames``
(mcalf/routines/hires_fitter.py:704-759) with the same file interface: reads
``<base>.stats`` + ``<base>_equal_weights.txt``.

A copy of :mod:`mcalf_tpu.analysis` (host numpy) that reads through the
port's :mod:`mcalf_torch.io.chains`; tests/test_torch_runner_variants.py
holds the two equal on the same chain files.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mcalf_torch.io.chains import read_equal_weights, read_stats

__all__ = ["analyze_chains", "sort_components", "get_parnames", "ncomp_occurrence"]


def sort_components(
    postsamples: np.ndarray,
    startind: int | None = None,
    nfill: int = 0,
) -> np.ndarray:
    """Per-sample: NaN out dimensions beyond the active component count and
    sort the active (N, z, b) triplets by redshift.

    Mirrors the reference's post-hoc label-switching treatment
    (hires_fitter.py:723-745): for each posterior sample, the first
    ``floor(p[startind])`` triplets after the ncomp slot are kept (z-sorted),
    everything beyond is NaN.  ``startind`` defaults to the reference's
    layout inference ``(ncols - 1) % 3`` (valid for the
    [head..., ncomp, triplets...] layout, :728).

    ``nfill``: number of trailing FILLER triplets to exclude from the
    sort-and-mask.  The reference NaNs everything beyond the active
    components INCLUDING the always-active filler parameters
    (hires_fitter.py:737 ``postsamples[ii, thisendind:] = 99``), which
    silently blanks the filler absorption out of its own posterior-overlay
    plots for any nfill > 0 fit -- a reference bug we do not replicate
    when the caller can supply ``nfill`` (run_plot does; the default 0
    reproduces the reference's chain-only inference, which cannot know the
    layout).
    """
    post = np.array(postsamples, dtype=np.float64, copy=True)
    n, ncols = post.shape
    if startind is None:
        startind = (ncols - 1) % 3
    out = post.copy()
    # Fully vectorized (the per-sample Python loop crawls on ~40k-row
    # chains): view the triplet block as (n, K, 3), key inactive triplets
    # with +inf so a stable argsort moves the active ones, z-ordered, to the
    # front, then NaN everything inactive.
    K = (ncols - startind - 1) // 3 - int(nfill)
    if K <= 0:
        return out
    trip = post[:, startind + 1 : startind + 1 + 3 * K].reshape(n, K, 3)
    ncomp = np.clip(post[:, startind].astype(np.int64), 0, K)
    active = np.arange(K)[None, :] < ncomp[:, None]
    zkey = np.where(active, trip[:, :, 1], np.inf)
    order = np.argsort(zkey, axis=1, kind="stable")
    trip = np.take_along_axis(trip, order[:, :, None], axis=1)
    active = np.take_along_axis(active, order, axis=1)
    trip = np.where(active[:, :, None], trip, np.nan)
    out[:, startind + 1 : startind + 1 + 3 * K] = trip.reshape(n, 3 * K)
    return out


def analyze_chains(
    filesbasename: str, return_sorted: bool = True, nfill: int = 0
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Read ``<base>.stats`` + ``<base>_equal_weights.txt`` and return
    (lnZ, lnZ_err, lnL samples, posterior samples) -- reference
    ``pc_analyzer`` semantics (hires_fitter.py:704-747).  ``nfill``
    preserves that many trailing filler triplets through the sort (see
    :func:`sort_components`)."""
    lnz, lnz_err = read_stats(filesbasename + ".stats")
    allsamples = read_equal_weights(filesbasename + "_equal_weights.txt")
    lhoodsamples = -0.5 * allsamples[:, 1]
    postsamples = allsamples[:, 2:]
    if return_sorted:
        postsamples = sort_components(postsamples, nfill=nfill)
    return lnz, lnz_err, lhoodsamples, postsamples


def get_parnames(ncomp: int, cont: bool = False) -> List[str]:
    """Human-readable parameter names (reference hires_fitter.py:749-759)."""
    names: List[str] = []
    if cont:
        names.append("Cont")
    for ii in range(ncomp):
        names += [f"N{ii+1}", f"z{ii+1}", f"b{ii+1}"]
    return names


def ncomp_occurrence(postsamples: np.ndarray, startind: int):
    """Posterior occurrence fraction of each active component count
    (reference cli.py:367-383).  Returns (ncomp values, fractions, MAP)."""
    vals, counts = np.unique(
        np.floor(postsamples[:, startind]).astype(int), return_counts=True
    )
    frac = counts / counts.sum()
    return vals, frac, int(vals[np.argmax(frac)])
