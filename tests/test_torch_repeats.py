"""The repeats ladder in the port (sampler/repeats.py): the rung
uncertainty against ``mcalf_tpu.sampler.repeats`` (exact), the per-rung
generators, and the Gaussian twins of tests/test_repeats.py at the same
sizes and bars."""

import numpy as np
import pytest
import torch

from mcalf_tpu.sampler import repeats as jrep
from mcalf_torch.sampler import NSConfig, converged_sample
from mcalf_torch.sampler import repeats as trep


def gaussian_loglike(sigma, ndim, mu=0.5):
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def loglike(u):
        r2 = torch.sum((u - mu) ** 2, dim=-1)
        return (norm - 0.5 * r2 / sigma**2).to(torch.float32)

    return loglike


@pytest.mark.parametrize(
    "logz,logzerr,scatter",
    [([1.0], 0.3, 0.0), ([1.0, 1.2], 0.3, 0.14), ([1.0, 2.5], 0.3, 1.06),
     ([0.1, 0.2, 0.4], 0.25, 0.15), ([], 0.2, 0.0)],
)
def test_rung_uncertainty_matches_jax(logz, logzerr, scatter):
    kw = dict(num_repeats=8, logz_seeds=logz, logzerr=logzerr, scatter=scatter,
              rank_p=[0.5] * len(logz), n_like=1000)
    assert trep.LadderRung._fields == jrep.LadderRung._fields
    assert trep.ConvergedRun._fields == jrep.ConvergedRun._fields
    assert trep._rung_uncertainty(trep.LadderRung(**kw)) == jrep._rung_uncertainty(
        jrep.LadderRung(**kw)
    )


def test_rung_generators_are_seeded_from_seed_rung_and_index():
    def first(seed, rung, index):
        return float(torch.rand((), generator=trep._rung_generator(seed, rung, index, "cpu")))

    draws = {(s, k, i): first(s, k, i) for s in (3, 4) for k in (0, 1, 2) for i in (0, 1)}
    assert len(set(draws.values())) == len(draws)  # every run its own stream
    assert first(3, 1, 0) == draws[3, 1, 0]        # and the same one every time


def test_ladder_escalates_from_undermixed_start():
    # Start DELIBERATELY under-mixed (num_repeats=2 at ndim=4, far below
    # the calibrated 12*ndim): the ladder must climb and finish on a rung
    # whose evidence is consistent with the analytic truth (logZ = 0).
    ndim, sigma = 4, 0.08
    cfg = NSConfig(ndim=ndim, nlive=100, num_repeats=2, max_samples=6000,
                   precision_criterion=1e-2)
    conv = converged_sample(
        gaussian_loglike(sigma, ndim), 3, cfg, "cpu", seeds=2, max_doublings=5,
    )
    assert len(conv.ladder) >= 2                 # at least one doubling ran
    assert conv.num_repeats > 2                  # it escalated
    assert conv.converged
    assert [r.num_repeats for r in conv.ladder] == [2 << k for k in range(len(conv.ladder))]
    # Merged evidence within 4 combined uncertainties of the truth (or 0.3).
    tol = 4 * max(conv.merged.logzerr, conv.ladder[-1].scatter / np.sqrt(2))
    assert abs(conv.merged.logz) < max(tol, 0.3), (conv.merged.logz, conv.ladder)
    # The final two rungs agree (that is the acceptance criterion).
    m1 = np.mean(conv.ladder[-1].logz_seeds)
    m0 = np.mean(conv.ladder[-2].logz_seeds)
    assert abs(m1 - m0) < 1.0, conv.ladder
    # the final rung's runs come back as host arrays, one per seed
    assert len(conv.results) == 2 and isinstance(conv.results[0].logl, np.ndarray)


def test_ladder_budget_exhaustion_reported():
    # With rank_p_min=1.0 no rung can pass the rank gate, so the ladder must
    # report converged=False after its budget.
    ndim, sigma = 2, 0.06
    cfg = NSConfig(ndim=ndim, nlive=60, num_repeats=8, max_samples=2500,
                   precision_criterion=1e-2)
    conv = converged_sample(
        gaussian_loglike(sigma, ndim), 5, cfg, "cpu",
        seeds=1, max_doublings=1, rank_p_min=1.0,
    )
    assert not conv.converged
    assert len(conv.ladder) == 2 and conv.num_repeats == 16
    # Results are still returned (lower-confidence estimate).
    assert np.isfinite(conv.merged.logz)


def test_ladder_is_reproducible_from_its_seed():
    cfg = NSConfig(ndim=2, nlive=40, num_repeats=4, max_samples=1500,
                   precision_criterion=1e-2)
    a, b = (
        converged_sample(gaussian_loglike(0.06, 2), 11, cfg, "cpu", seeds=2, max_doublings=1)
        for _ in range(2)
    )
    assert a.ladder == b.ladder and a.merged.logz == b.merged.logz
