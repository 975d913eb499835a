"""The port's evidence over many seeds: the twin of
tests/test_sampler.py::test_evidence_unbiased_over_seeds, at its settings
and bar, for each bracket.  The reference calls it the regression net for
the batch-deletion threshold (an off-by-one biases it +0.12 nats) and for
the step-out kernel.  The 24 seeds run as one stacked fleet
(``nested_sample_stacked``): seed s's run is bit for bit its solo run
(tests/test_torch_fleet.py), only faster here.
"""

import math

import numpy as np
import pytest
import torch

from mcalf_torch.sampler import NSConfig, finalize
from mcalf_torch.sampler.nested import nested_sample_stacked


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_evidence_unbiased_over_seeds(bracket):
    ndim, sigma, nseeds = 4, 0.08, 24
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def rows(u, prob):  # every seed fits the same Gaussian
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(torch.float32)

    cfg = NSConfig(ndim=ndim, nlive=100, num_delete=25, max_samples=8000, bracket=bracket)
    finals = nested_sample_stacked(
        rows, [torch.Generator().manual_seed(s) for s in range(nseeds)], cfg, "cpu")
    logzs = np.array([float(finalize(f, cfg).logz) for f in finals])
    sem = logzs.std(ddof=1) / np.sqrt(nseeds)
    assert abs(logzs.mean()) < max(3.0 * sem, 0.08), (logzs.mean(), sem)
