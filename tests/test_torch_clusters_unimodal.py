"""Mode clustering on a unimodal target in the port's sampler: the twin of
tests/test_clusters.py::test_clustered_matches_unclustered_on_unimodal, at
its settings and bars.  On one Gaussian, clustering must be a no-op
statistically: the 4-seed mean logZ with max_clusters = 1 and with 8 each
within 0.4 of the analytic 0.  The seeds of each setting run as one stacked
fleet (each seed bit for bit its solo run, tests/test_torch_fleet.py).
Slow, as the reference's module is."""

import math

import numpy as np
import pytest
import torch

from mcalf_torch.sampler import NSConfig, finalize
from mcalf_torch.sampler.nested import nested_sample_stacked

pytestmark = pytest.mark.slow


def test_clustered_matches_unclustered_on_unimodal():
    sigma = 0.05

    def rows(u, prob):
        return (-0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2
                - 2 * math.log(2 * math.pi * sigma**2)).to(torch.float32)

    means = {}
    for k in (1, 8):
        cfg = NSConfig(ndim=4, nlive=150, max_samples=12000, max_clusters=k)
        finals = nested_sample_stacked(
            rows, [torch.Generator().manual_seed(s) for s in range(4)], cfg, "cpu")
        means[k] = float(np.mean([float(finalize(f, cfg).logz) for f in finals]))
    # per-run scatter is ~0.25 nats (logzerr at nlive=150), so compare each
    # 4-seed mean to the analytic truth (logZ = 0) rather than to each other
    assert abs(means[1]) < 0.4, means
    assert abs(means[8]) < 0.4, means
