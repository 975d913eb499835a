"""Posterior post-processing for nested-sampling results (host numpy).

Port of :mod:`mcalf_tpu.sampler.results`: equal-weight resampling to the
reference's ``_equal_weights.txt`` matrix ``[weight=1, -2 lnL, params...]``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["resample_equal", "posterior_stats", "equal_weights_matrix"]


def _np(x, dtype) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def resample_equal(
    gen: torch.Generator, results, S: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw S equally weighted posterior samples (with replacement) from the
    weighted dead-point set: inverse-CDF multinomial draws in float64 on the
    host, O(N + S) memory.  The S uniforms come from ``gen`` (a CPU
    generator).  Returns (samples_u (S, ndim) float32, logl (S,) float32).

    ``results`` is an :class:`~mcalf_torch.sampler.nested.NSResults` (tensors
    or numpy) or a :class:`~mcalf_torch.sampler.merge.MergedRun`: anything
    with ``samples_u``, ``logl`` and ``log_posterior_weights``."""
    logp = _np(results.log_posterior_weights, np.float64)
    w = np.exp(logp - logp.max())
    cdf = np.cumsum(w)
    u = torch.rand((S,), generator=gen, dtype=torch.float32).numpy().astype(np.float64)
    idx = np.searchsorted(cdf, u * cdf[-1], side="right")
    idx = np.clip(idx, 0, logp.size - 1)
    return (
        _np(results.samples_u, np.float32)[idx],
        _np(results.logl, np.float32)[idx],
    )


def posterior_stats(results):
    """Weighted posterior mean/std per unit-cube dimension (host numpy)."""
    logp = _np(results.log_posterior_weights, np.float64)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    u = _np(results.samples_u, np.float64)
    mean = (w[:, None] * u).sum(axis=0)
    var = (w[:, None] * (u - mean) ** 2).sum(axis=0)
    return mean, np.sqrt(var)


def equal_weights_matrix(samples_phys: np.ndarray, logl: np.ndarray) -> np.ndarray:
    """Chain matrix in the reference's `_equal_weights.txt` layout:
    col0 weight (=1), col1 -2 lnL, cols 2+ the physical parameter vector."""
    samples_phys = np.asarray(samples_phys, np.float64)
    logl = np.asarray(logl, np.float64)
    n = samples_phys.shape[0]
    return np.hstack([np.ones((n, 1)), (-2.0 * logl)[:, None], samples_phys])
