"""Gauge fixing by ``canon_layout`` in the port's sampler: the twin of
tests/test_sampler.py::test_canon_layout_gauge_fixing_preserves_evidence, at
its settings and bar.  A likelihood symmetric under swapping the two
(N, z, b) triplets of a 2-component layout: fixing the gauge must leave
logZ statistically unchanged (6-seed means within 0.4).  The seeds of each
setting run as one stacked fleet.  Slow, as the reference's test is."""

import numpy as np
import pytest
import torch

from mcalf_torch.sampler import NSConfig, finalize
from mcalf_torch.sampler.nested import nested_sample_stacked

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_canon_layout_gauge_fixing_preserves_evidence():
    sigma = 0.1

    def rows(u, prob):
        a, b = u[..., 1:4], u[..., 4:7]
        r2 = torch.minimum(
            torch.sum((a - 0.3) ** 2, -1) + torch.sum((b - 0.7) ** 2, -1),
            torch.sum((a - 0.7) ** 2, -1) + torch.sum((b - 0.3) ** 2, -1),
        )
        return (-0.5 * r2 / sigma**2).to(torch.float32)

    z = []
    for layout in (None, (0, 2, 0, 2.0, 2.0)):
        cfg = NSConfig(ndim=7, nlive=100, max_samples=8000, canon_layout=layout)
        finals = nested_sample_stacked(
            rows, [torch.Generator().manual_seed(s) for s in range(6)], cfg, "cpu")
        z.append(float(np.mean([float(finalize(f, cfg).logz) for f in finals])))
    assert abs(z[0] - z[1]) < 0.4, z
