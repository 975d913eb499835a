"""Per-problem chain files of a fleet.

Port of :mod:`mcalf_tpu.parallel.results_io`: after
:func:`mcalf_torch.parallel.fit_many` returns stacked results, each
problem's posterior goes to the reference's chain format (``.stats`` and
``_equal_weights.txt``), so analysis reads a fleet member as it reads a
solo fit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mcalf_torch.io.chains import write_equal_weights, write_stats
from mcalf_torch.models.batched import index_consts
from mcalf_torch.sampler.nested import NSResults, unstack_results
from mcalf_torch.sampler.results import equal_weights_matrix, resample_equal

__all__ = ["save_fleet_results", "fleet_summary"]


def save_fleet_results(
    results: NSResults,
    stacked_consts: Dict,
    basenames: Sequence[str],
    resample_S: int = 0,
    seed: int = 42,
) -> None:
    """Write ``<base>.stats`` + ``<base>_equal_weights.txt`` for each problem
    of a stacked fleet result: S equal-weight rows per problem (``n_dead``
    when ``resample_S`` is 0), drawn with ``torch.Generator().manual_seed(
    seed)``; physical parameters from the problem's own prior bounds in
    ``stacked_consts`` (numpy, as ``stack_problems`` gives them)."""
    for i, (r, base) in enumerate(zip(unstack_results(results), basenames)):
        write_stats(base + ".stats", float(r.logz), float(r.logzerr))
        S = resample_S if resample_S > 0 else int(r.n_dead)
        su, logl = resample_equal(torch.Generator().manual_seed(seed), r, S)
        c = index_consts(stacked_consts, i)
        lo = torch.as_tensor(np.asarray(c["lo"], np.float32))
        hi = torch.as_tensor(np.asarray(c["hi"], np.float32))
        params = (lo + torch.from_numpy(su) * (hi - lo)).numpy().astype(np.float64)
        write_equal_weights(base + "_equal_weights.txt", equal_weights_matrix(params, logl))


def fleet_summary(results: NSResults) -> np.ndarray:
    """(n_problems, 5) array: logZ, logZerr, H, n_like, converged."""
    f64 = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(np.float64)
    return np.stack(
        [
            f64(results.logz),
            f64(results.logzerr),
            f64(results.h),
            f64(results.n_like),
            (np.asarray(results.termination_reason) == 0).astype(np.float64),
        ],
        axis=1,
    )
