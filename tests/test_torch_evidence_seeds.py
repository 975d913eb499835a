"""The port's evidence over many seeds: the twin of
tests/test_sampler.py::test_evidence_unbiased_over_seeds, at its settings
and bar, for each bracket.  The reference calls it the regression net for
the batch-deletion threshold (an off-by-one biases it +0.12 nats) and for
the step-out kernel.  The 24 seeds run as one stacked fleet
(``nested_sample_stacked``): seed s's run is bit for bit its solo run
(tests/test_torch_fleet.py), only faster here.  The reference's test runs
``nested_sample_device`` (a fixed budget of outer steps, no
re-clustering); its twin here runs the port's through its stacked form,
whose members are their solo runs (tests/test_torch_sampler_api.py).
"""

import math

import numpy as np
import pytest
import torch

from mcalf_torch.sampler import NSConfig, finalize
from mcalf_torch.sampler.nested import _nested_sample_device_stacked, nested_sample_stacked


NDIM, SIGMA, NSEEDS = 4, 0.08, 24


def _rows(u, prob):  # every seed fits the same normalised Gaussian
    norm = -0.5 * NDIM * math.log(2 * math.pi * SIGMA**2)
    return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / SIGMA**2).to(torch.float32)


def _unbiased(run, cfg):
    finals = run(_rows, [torch.Generator().manual_seed(s) for s in range(NSEEDS)], cfg, "cpu")
    logzs = np.array([float(finalize(f, cfg).logz) for f in finals])
    sem = logzs.std(ddof=1) / np.sqrt(NSEEDS)
    assert abs(logzs.mean()) < max(3.0 * sem, 0.08), (logzs.mean(), sem)


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_evidence_unbiased_over_seeds(bracket):
    cfg = NSConfig(ndim=NDIM, nlive=100, num_delete=25, max_samples=8000, bracket=bracket)
    _unbiased(nested_sample_stacked, cfg)


def test_device_evidence_unbiased_over_seeds():
    """``nested_sample_device``, at the reference test's settings."""
    cfg = NSConfig(ndim=NDIM, nlive=100, num_delete=25, max_samples=8000)
    _unbiased(_nested_sample_device_stacked, cfg)
