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


def test_the_window_is_the_runs_middle_fits(traced):
    """One window fit of two seeds between the warm-up and the profiled
    fit: three merges, three fits of three file pairs; the warm-up's and the
    profiled fit's two outer steps each."""
    out, registry = traced
    assert len(registry["nested_sampling"]) == 3 and len(registry["runner.merge"]) == 3
    assert len(registry["runner.files"]) == 9
    rec = {"fits": 1, "ns_s": registry["nested_sampling"][1], "profile": {}}
    assert spans.is_this_run(rec, registry)
    assert spans.window(rec, "runner.merge") == registry["runner.merge"][1:2]
    assert spans.window(rec, "runner.files") == registry["runner.files"][3:6]
    loops = registry["sampler.slice_loop"]
    assert spans.window(rec, "sampler.slice_loop", per_edge_fit=2) == loops[2:-2]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_registry_not_the_runs_reads_nothing(traced, name, monkeypatch):
    _, registry = traced
    rec = {"fits": 1, "ns_s": registry["nested_sampling"][1], "profile": {}, "capture_s": 0.0}
    read = harness.metric_reader(name)
    # another fit's spans in the process
    extra = dict(registry, nested_sampling=registry["nested_sampling"] + [1.0])
    monkeypatch.setattr(spans, "_registry", lambda: extra)
    assert read(rec) is None
    # a fitter without the span (the parent of these metrics)
    monkeypatch.setattr(spans, "_registry",
                        lambda: {"nested_sampling": registry["nested_sampling"]})
    assert read(rec) is None
    monkeypatch.setattr(spans, "_registry", lambda: registry)
    assert read(rec) is not None
