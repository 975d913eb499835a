"""Plain float64 reference of a nested-sampling run's weights and evidence.

A run with ``nlive`` live points deletes ``num_delete`` points per outer
step, in increasing log L.  The j-th deletion of a step (j = 0..B-1)
shrinks the prior volume by d ln X = -1 / (nlive - j); a dead point's
prior-mass weight is X_before - X_after, and the live points left at the
end each carry X_final / nlive.  Several independent runs of one problem
merge by birth contours: at each death (in increasing log L) the live count
is the number of points born below that log L less those already dead.
Nothing here imports the fitter.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _logsumexp(a: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    a = a[np.isfinite(a)]
    if a.size == 0:
        return -np.inf
    m = a.max()
    return float(m + np.log(np.exp(a - m).sum()))


def _weights(logx: np.ndarray) -> np.ndarray:
    prev = np.concatenate([[0.0], logx[:-1]])
    with np.errstate(divide="ignore"):
        return prev + np.log1p(-np.exp(logx - prev))


def run_weights(n_dead: int, nlive: int, num_delete: int, rounding=None) -> Tuple[np.ndarray, np.ndarray]:
    """(log weights of the n_dead dead points, log weight of each final live
    point).  ``rounding``: a function applied after each step (the
    reference's arithmetic is float64; a control's is lower)."""
    rnd = rounding or (lambda a: np.asarray(a, np.float64))
    if n_dead % num_delete:
        raise ValueError(f"{n_dead} deaths are not whole steps of {num_delete}")
    steps = n_dead // num_delete
    j = np.arange(num_delete, dtype=np.float64)
    cum = np.cumsum(-1.0 / (nlive - j))
    logx = (np.arange(steps)[:, None] * cum[-1] + cum[None, :]).reshape(-1)
    logx = np.asarray(rnd(logx), np.float64)
    logw = np.asarray(rnd(_weights(logx)), np.float64)
    final = logx[-1] if n_dead else 0.0
    return logw, float(rnd(np.float64(final - np.log(nlive))))


def run_logz(dead_logl: np.ndarray, live_logl: np.ndarray, nlive: int, num_delete: int,
             rounding=None) -> float:
    """log Z of one run from its dead points' log L (in order of death) and
    its final live points' log L.  ``rounding``: see :func:`run_weights`."""
    rnd = rounding or (lambda a: np.asarray(a, np.float64))
    logw, live_w = run_weights(len(dead_logl), nlive, num_delete, rounding)
    terms = np.concatenate([logw + rnd(dead_logl), live_w + rnd(live_logl)])
    return _logsumexp(np.asarray(rnd(terms), np.float64))


def merged_logz(runs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> float:
    """log Z of several runs merged by birth contours; each run is (log L,
    birth log L) of all its points (dead and final live)."""
    logl = np.concatenate([np.asarray(l, np.float64) for l, _ in runs])
    birth = np.concatenate([np.asarray(b, np.float64) for _, b in runs])
    order = np.argsort(logl, kind="stable")
    logl, birth = logl[order], birth[order]
    born = np.searchsorted(np.sort(birth), logl, side="left")
    died = np.searchsorted(logl, logl, side="left")
    nlive = np.maximum(born - died, 1)
    logw = _weights(np.cumsum(-1.0 / nlive))
    return _logsumexp(np.where(np.isfinite(logl), logw + logl, -np.inf))
