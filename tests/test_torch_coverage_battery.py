"""The SBC posterior-coverage battery of the port on the CPU: the twin of
tests/test_coverage.py, at its size and gates (32 prior-drawn 1-comp CIV
realizations, nlive 100, max_samples 6000, as one stacked fleet through
tools/torch_coverage_study.py).  Slow, as the JAX package's is."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parents[1] / "tools"))

pytestmark = pytest.mark.slow


def test_sbc_rank_and_interval_coverage():
    from torch_coverage_study import run_coverage

    out = run_coverage(n_real=32, nlive=100, max_samples=6000, mesh=["cpu"])
    assert out["converged_all"]
    assert out["ranks_ok"], out["rank_ks_p"]
    for lvl in ("0.68", "0.95"):
        assert out["coverage"][lvl]["ok"], out["coverage"]
