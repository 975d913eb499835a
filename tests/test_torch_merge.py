"""Run merging via birth contours in the port: the numpy copy against
``mcalf_tpu.sampler.merge`` on the same arrays (rtol 1e-12), single-run
invariance and multi-run error reduction on the port's own sampler (the
bars of tests/test_merge.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcalf_tpu.sampler import merge as jmerge
from mcalf_torch.sampler import NSConfig, nested_sample, posterior_stats, resample_equal
from mcalf_torch.sampler import merge as tmerge
from mcalf_torch.sampler.merge import merge_results


def _synthetic_run(seed, nlive=40, ndead=300, cap=400, ndim=3, birth_floor=None):
    """Arrays of the NSResults layout (dead buffer of ``cap`` rows, ``ndead``
    filled, then ``nlive`` live rows), made from a seed with numpy: sorted
    deaths, each point born at an earlier death's contour (or at the prior,
    -inf; at ``birth_floor`` for a boost-like run), unfilled rows marked by
    logw = -inf."""
    rng = np.random.default_rng(seed)
    n = ndead + nlive
    logl = np.sort(rng.normal(-20.0, 8.0, n)).astype(np.float32)
    birth = np.full(n, -np.inf if birth_floor is None else birth_floor, np.float32)
    for i in range(nlive, n):
        birth[i] = logl[rng.integers(0, i - nlive + 1)]
    if birth_floor is not None:
        logl = np.maximum(logl, np.float32(birth_floor) + 1e-3).astype(np.float32)
        birth = np.minimum(birth, logl - 1e-3).astype(np.float32)
        birth = np.maximum(birth, np.float32(birth_floor))
    logw = (-(np.arange(n) + 1.0) / nlive - np.log(nlive)).astype(np.float32)
    pad = cap - ndead

    def padded(x, fill):
        return np.concatenate([x[:ndead], np.full((pad,) + x.shape[1:], fill, x.dtype), x[ndead:]])

    u = rng.uniform(size=(n, ndim)).astype(np.float32)
    return SimpleNamespace(
        samples_u=padded(u, 0.0), logl=padded(logl, -np.inf),
        logw=padded(logw, -np.inf), birth_logl=padded(birth, np.inf),
    )


@pytest.mark.parametrize("case", ["one", "four", "base+boost", "ties"])
def test_merge_results_matches_jax(case):
    if case == "one":
        runs = [_synthetic_run(1)]
    elif case == "four":
        runs = [_synthetic_run(10 + k, nlive=30 + 5 * k, ndead=200 + 40 * k) for k in range(4)]
    elif case == "base+boost":
        runs = [_synthetic_run(3), _synthetic_run(4, nlive=25, birth_floor=-22.0)]
    else:  # equal likelihoods across runs, -inf deaths
        a, b = _synthetic_run(5), _synthetic_run(5)
        a.logl[:7] = -np.inf
        runs = [a, b]
    want, got = jmerge.merge_results(runs), merge_results(runs)
    assert got._fields == want._fields
    for k in want._fields:
        w, g = np.asarray(getattr(want, k)), np.asarray(getattr(got, k))
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0.0, err_msg=k)
    grid = np.linspace(-60.0, 10.0, 57)
    np.testing.assert_array_equal(tmerge.nlive_of_logl(got, grid), jmerge.nlive_of_logl(want, grid))
    # the merged run feeds the port's resampler and posterior_stats
    su, logl = resample_equal(torch.Generator().manual_seed(42), got, 500)
    assert su.shape == (500, 3) and su.dtype == np.float32 and np.all(np.isfinite(logl))
    mean, std = posterior_stats(got)
    assert mean.shape == std.shape == (3,) and np.all((mean > 0) & (mean < 1))


@pytest.mark.parametrize("n,seed", [(0, 7), (1, 7), (500, 7), (500, 11)])
def test_simulated_logzerr_matches_jax(n, seed):
    rng = np.random.default_rng(n + seed)
    logl = np.sort(rng.normal(0.0, 5.0, n))
    nlive = rng.integers(1, 200, n).astype(np.int64)
    want = jmerge._simulated_logzerr(logl, nlive, ndraw=32, seed=seed)
    got = tmerge._simulated_logzerr(logl, nlive, ndraw=32, seed=seed)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def _loglike(sigma=0.05, ndim=2):
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def f(u):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(torch.float32)

    return f


def _run(seed, cfg):
    return nested_sample(_loglike(), torch.Generator().manual_seed(seed), cfg, "cpu").numpy()


def test_single_run_merge_reproduces_bookkeeping():
    """Merging one run must reproduce its own logZ (to 0.05): the birth/death
    volume reconstruction equals the incremental bookkeeping of the run."""
    cfg = NSConfig(ndim=2, nlive=150, max_samples=10000)
    res = _run(0, cfg)
    merged = merge_results([res])
    assert abs(merged.logz - float(res.logz)) < 0.05, (merged.logz, float(res.logz))
    # Batch deletion (B = num_delete) cycles the live count between nlive
    # and nlive-B+1 in likelihood space, so the bulk median sits near
    # nlive - B/2 (with slack for the sawtooth phase).
    B = cfg.resolved().num_delete
    med = np.median(merged.nlive_at_death[: merged.logl.size // 2])
    assert 150 - B / 2 - 15 <= med <= 150, med


def test_multi_run_merge_reduces_error():
    cfg = NSConfig(ndim=2, nlive=100, max_samples=10000)
    runs = [_run(k, cfg) for k in range(4)]
    merged = merge_results(runs)
    single_err = float(runs[0].logzerr)
    # K=4 runs: error shrinks ~2x; logZ stays consistent with truth (0).
    assert merged.logzerr < 0.7 * single_err
    assert abs(merged.logz) < max(4 * merged.logzerr, 0.1), merged.logz
    # merged live counts ~ 4 * (nlive - B/2) in the bulk (with slack for
    # the deletion sawtooth phase)
    B = cfg.resolved().num_delete
    med = np.median(merged.nlive_at_death[: merged.logl.size // 2])
    assert med > 4 * (100 - B / 2) - 30, med
