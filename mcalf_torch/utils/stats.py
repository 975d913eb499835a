"""Small host-side statistics helpers (astropy replacements).

A copy of :mod:`mcalf_tpu.utils.stats` (``mcalf_tpu.utils.__init__``
imports jax)."""

from __future__ import annotations

import numpy as np


def sigma_clipped_stats(data, sigma: float = 3.0, maxiters: int = 5):
    """Mean/median/std of iteratively sigma-clipped data.

    Drop-in for ``astropy.stats.sigma_clipped_stats`` defaults (clip about the
    median at ``sigma`` standard deviations, up to ``maxiters`` passes), used
    by the reference to derive the per-pixel velocity step
    (hires_fitter.py:84-87).
    """
    arr = np.asarray(data, dtype=np.float64)
    arr = arr[np.isfinite(arr)]
    mask = np.ones(arr.shape, dtype=bool)
    for _ in range(int(maxiters)):
        cur = arr[mask]
        if cur.size == 0:
            break
        med = np.median(cur)
        std = np.std(cur, ddof=1) if cur.size > 1 else 0.0
        new_mask = np.abs(arr - med) <= sigma * std
        if new_mask.sum() == mask.sum() and np.all(new_mask == mask):
            break
        if new_mask.sum() == 0:
            break
        mask = new_mask
    cur = arr[mask]
    mean = float(np.mean(cur))
    median = float(np.median(cur))
    std = float(np.std(cur, ddof=1)) if cur.size > 1 else 0.0
    return mean, median, std
