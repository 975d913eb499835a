"""benchmark/metrics/hjert_line_pct.py: the share of the fused kernel's
(row, transition) evaluations that took the damped Voigt function, read
from the fitter's counters; nothing on a fitter without them (the commit
before they were added) or before any fused launch."""

import pytest

import _common  # noqa: F401 (the repository root on the path)

from benchmark import harness


@pytest.fixture
def read():
    return harness.metric_reader("hjert_line_pct")


def test_reads_the_counters(read, monkeypatch):
    from mcalf_torch.ops import voigt_cuda

    monkeypatch.setattr(voigt_cuda, "lines", 800 * 22 * 5)
    monkeypatch.setattr(voigt_cuda, "hjert_lines", 800 * 22 * 5)
    assert read({}) == 100.0
    monkeypatch.setattr(voigt_cuda, "hjert_lines", 800 * 11)
    assert read({}) == pytest.approx(10.0)
    monkeypatch.setattr(voigt_cuda, "hjert_lines", 0)
    assert read({}) == 0.0


def test_none_without_the_counters_or_a_launch(read, monkeypatch):
    from mcalf_torch.ops import voigt_cuda

    monkeypatch.setattr(voigt_cuda, "lines", 0)
    monkeypatch.setattr(voigt_cuda, "hjert_lines", 0)
    assert read({}) is None
    monkeypatch.delattr(voigt_cuda, "lines")
    monkeypatch.delattr(voigt_cuda, "hjert_lines")
    assert read({}) is None
