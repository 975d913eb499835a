"""Mode clustering in the port's sampler: the twin of
tests/test_clusters.py::test_two_mode_evidence_and_mass_split, at its
settings and bars.  A well-separated two-mode posterior, where a global
covariance smears the proposal geometry across the gap: the clustered
kernel must recover the analytic evidence (logZ = 0) and the 50/50 split.
"""

import math

import numpy as np
import pytest
import torch

from mcalf_torch.sampler import NSConfig, nested_sample, posterior_cluster_report


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_mode_loglike(sigma, ndim, w1=0.5):
    """Equal-width Gaussians at 0.25 and 0.75 with masses w1 / 1-w1:
    Z = 1 exactly (sigma small), logZ = 0."""
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def loglike(u):
        r1 = torch.sum((u - 0.25) ** 2, dim=-1)
        r2 = torch.sum((u - 0.75) ** 2, dim=-1)
        l1 = norm + math.log(w1) - 0.5 * r1 / sigma**2
        l2 = norm + math.log(1 - w1) - 0.5 * r2 / sigma**2
        return torch.logaddexp(l1, l2).to(torch.float32)

    return loglike


def test_two_mode_evidence_and_mass_split():
    ndim, sigma = 4, 0.03
    ll = _two_mode_loglike(sigma, ndim)
    cfg = NSConfig(ndim=ndim, nlive=400, max_samples=40000, max_clusters=8)
    logzs, masses = [], []
    for seed in (0, 1, 2):
        res = nested_sample(ll, torch.Generator().manual_seed(seed), cfg, "cpu").numpy()
        assert res.termination_reason == 0
        logzs.append(float(res.logz))
        rep = posterior_cluster_report(res, max_clusters=8)
        assert rep.k == 2, rep.k
        masses.append(float(rep.mass[0]))
        # the two mode means sit at the two centers
        centers = sorted(rep.mean_u[:, 0])
        assert abs(centers[0] - 0.25) < 0.03
        assert abs(centers[1] - 0.75) < 0.03
    # evidence: mean over seeds consistent with the analytic logZ = 0
    assert abs(np.mean(logzs)) < 0.25, logzs
    # mass split: the larger mode holds ~half the mass, not all of it
    assert np.mean(masses) < 0.62, masses
