"""The per-layer metrics that read the fitter's own phase spans
(benchmark/spans.py): a tiny traced CPU run reads each, and each finds
nothing in a registry that is not the run's or lacks its span."""

import math

import pytest

import _common

from benchmark import harness, spans

#: the metrics of BENCHMARK.json that read the fitter's phase spans
SPAN_METRICS = ("sampler_host_ms_per_fit", "merge_ms_per_fit", "files_ms_per_fit")


@pytest.fixture(scope="module")
def traced():
    from mcalf_torch.utils import profiling

    profiling.reset_timings()  # the registry then holds this run alone
    out = _common.tiny_run(trace=1)
    return out, profiling.get_timings()


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_traced_run_reads_the_span_metrics(traced, name):
    out, _ = traced
    assert out["correct"]
    value = out["metrics"][name]["value"]
    assert math.isfinite(value) and value > 0


def _window_rec(registry):
    """The record of the traced run's window: its one fit of two seeds
    between the warm-up and the profiled fit, each of which made one merge,
    three file pairs and two outer steps."""
    first = {"nested_sampling": 1, "runner.merge": 1, "runner.files": 3, "sampler.slice_loop": 2}
    after = {"nested_sampling": 1, "runner.merge": 1, "runner.files": 3, "sampler.slice_loop": 2}
    closed = {k: len(registry[k]) - n for k, n in after.items()}
    return {"fits": 1, "ns_s": registry["nested_sampling"][1], "profile": {}, "capture_s": 0.0,
            "span_marks": [first, closed]}


def test_the_window_is_the_runs_middle_fits(traced):
    """One window fit of two seeds between the warm-up and the profiled
    fit: three merges, three fits of three file pairs; the warm-up's and the
    profiled fit's two outer steps each.  The run's own marks of the
    registry read the window's entries: its metrics are their sums."""
    out, registry = traced
    assert len(registry["nested_sampling"]) == 3 and len(registry["runner.merge"]) == 3
    assert len(registry["runner.files"]) == 9
    rec = _window_rec(registry)
    assert spans.is_this_run(rec, registry)
    assert spans.window(rec, "runner.merge") == registry["runner.merge"][1:2]
    assert spans.window(rec, "runner.files") == registry["runner.files"][3:6]
    loops = registry["sampler.slice_loop"]
    assert spans.window(rec, "sampler.slice_loop") == loops[2:-2]
    assert out["metrics"]["merge_ms_per_fit"]["value"] == 1e3 * registry["runner.merge"][1]
    assert out["metrics"]["files_ms_per_fit"]["value"] == 1e3 * sum(registry["runner.files"][3:6])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_registry_not_the_runs_reads_nothing(traced, name, monkeypatch):
    _, registry = traced
    rec = _window_rec(registry)
    read = harness.metric_reader(name)
    # another fit's spans ahead of the run's in the process
    extra = dict(registry, nested_sampling=[1.0] + registry["nested_sampling"])
    monkeypatch.setattr(spans, "_registry", lambda: extra)
    assert read(rec) is None
    # a registry emptied since the run's marks
    monkeypatch.setattr(spans, "_registry", lambda: {})
    assert read(rec) is None
    # a fitter without the span (the parent of these metrics)
    monkeypatch.setattr(spans, "_registry",
                        lambda: {"nested_sampling": registry["nested_sampling"]})
    assert read(rec) is None
    monkeypatch.setattr(spans, "_registry", lambda: registry)
    assert read(rec) is not None
