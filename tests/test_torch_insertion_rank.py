"""Insertion-rank uniformity of the port's sampler: the twin of
tests/test_sampler.py::test_insertion_rank_uniformity, at its settings and
bars (Fowlie, Handley & Su 2020: replacement insertion ranks among the
survivors are uniform for a correctly constrained sampler).  Slow, as the
reference's test is."""

import math

import pytest
import torch

from mcalf_torch.sampler import NSConfig, insertion_rank_test, nested_sample

pytestmark = pytest.mark.slow


def test_insertion_rank_uniformity():
    ndim, sigma = 3, 0.06
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def loglike(u):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(torch.float32)

    cfg = NSConfig(ndim=ndim, nlive=120, num_delete=30, max_samples=9000)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = nested_sample(loglike, torch.Generator().manual_seed(11), cfg, "cpu").numpy()
    finally:
        torch.set_num_threads(n)
    diag = insertion_rank_test(res, cfg)
    assert diag.n > 1000
    assert diag.n_levels == 91
    assert diag.p_value > 0.005, diag
    assert diag.p_value_blocks > 0.005, diag
    # ranks fill the full support
    assert diag.ranks.min() == 0 and diag.ranks.max() == 90
