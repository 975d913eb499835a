"""tools/torch_coverage_study.py, the port's SBC posterior-coverage study,
against the JAX package's tools/coverage_study.py.

* The mock problems (truths from the prior, noisy 1-comp CIV spectra) are
  the JAX study's byte for byte: its ``fit_many`` is replaced by a stub
  that keeps what it is handed.
* The summary (weighted ranks, KS p-values, interval coverage) is the JAX
  study's dict for the same fitted samples.
* A 4-realization run of the whole study through the port's fleet on the
  CPU, for its flow and shape.  The 32-realization battery with the JAX
  test's gates is tests/test_torch_coverage_battery.py (slow).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parents[1] / "tools"))

import coverage_study as jstudy  # noqa: E402
import torch_coverage_study as tstudy  # noqa: E402


class _Stop(Exception):
    pass


def _jax_study(monkeypatch, n_real, fitted=None):
    """Run the JAX study with its fleet replaced: returns the problems it
    built, and its summary when ``fitted`` gives the fleet's results."""
    import mcalf_tpu.parallel

    seen = []

    def fit_many(problems, cfg, seed, mesh):
        seen.append((problems, cfg, seed))
        if fitted is None:
            raise _Stop
        return fitted

    monkeypatch.setattr(mcalf_tpu.parallel, "fit_many", fit_many)
    try:
        out = jstudy.run_coverage(n_real=n_real)
    except _Stop:
        out = None
    return seen[0], out


def test_problems_are_the_jax_studys(monkeypatch):
    (jprobs, jcfg, jseed), _ = _jax_study(monkeypatch, 6)
    truths, tprobs = tstudy.make_problems(6, 20260819, 0.02)
    assert len(tprobs) == len(jprobs) == 6 and truths.shape == (6, 4)
    assert jseed == 20260819 % 100000 and (jcfg.nlive, jcfg.max_samples) == (100, 6000)
    for a, b in zip(jprobs, tprobs):
        for attr in ("obj_wl", "obj", "obj_noise", "valid", "bounds_lo", "bounds_hi"):
            x, y = getattr(a, attr), getattr(b, attr)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), attr
        assert a.ndim == b.ndim == 4
    # different realizations: distinct spectra
    assert not np.array_equal(tprobs[0].obj, tprobs[1].obj)


def test_summary_is_the_jax_studys(monkeypatch):
    """The same fitted samples through both summaries give the same dict."""
    from types import SimpleNamespace

    n_real, cap, ndim = 12, 300, 4
    rng = np.random.default_rng(2)
    samples = rng.uniform(size=(n_real, cap, ndim)).astype(np.float32)
    logpw = rng.normal(0.0, 2.0, (n_real, cap)).astype(np.float32)
    term = np.zeros(n_real, np.int32)
    fitted = SimpleNamespace(samples_u=samples, log_posterior_weights=logpw, termination_reason=term)
    _, want = _jax_study(monkeypatch, n_real, fitted)
    truths, _ = tstudy.make_problems(n_real, 20260819, 0.02)
    got = tstudy.summarize(samples, logpw.astype(np.float64), truths, term, 100)
    assert got == want


def test_four_realizations_through_the_fleet():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        stats = {}
        out = tstudy.run_coverage(n_real=4, nlive=20, max_samples=200, mesh=["cpu"],
                                  fit_stats=stats)
    finally:
        torch.set_num_threads(n)
    assert set(out) == {"n_realizations", "ndim", "nlive", "converged_all", "rank_ks_p",
                        "coverage", "ranks_ok"}
    assert (out["n_realizations"], out["ndim"], out["nlive"]) == (4, 4, 20)
    assert len(out["rank_ks_p"]) == 4 and all(0.0 <= p <= 1.0 for p in out["rank_ks_p"])
    for lvl in ("0.68", "0.95"):
        assert len(out["coverage"][lvl]["fraction_per_dim"]) == 4
    assert stats["n_like"] > 0 and stats["wall_s"] > 0
