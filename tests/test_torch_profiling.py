"""The port's profiling hooks (mcalf_torch/utils/profiling.py) against the
JAX package's (mcalf_tpu/utils/profiling.py): the same phase-timer registry
semantics, a trace that is a no-op without a directory and writes a trace
file with one, and the runner timing its nested sampling as the JAX
runner does."""

import json
import time
from pathlib import Path

import pytest
import torch

from mcalf_tpu.utils import profiling as jprof
from mcalf_torch.utils import profiling as tprof

TESTDATA = Path(__file__).parents[1] / "testdata"
CFG = """
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {datadir}/
outdir = {out}/
chainfmt = fit_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
device = cpu

[ns_settings]
nlive = 40
num_repeats = 4
max_samples = 400
precision_criterion = 0.01
"""


def _registry_run(mod):
    mod.reset_timings()
    with mod.phase_timer("outer"):
        time.sleep(0.01)
        with mod.phase_timer("inner"):
            time.sleep(0.01)
    with mod.phase_timer("inner"):
        pass
    try:
        with mod.phase_timer("boom"):
            raise RuntimeError
    except RuntimeError:
        pass
    t = mod.get_timings()
    mod.reset_timings()
    return t, mod.get_timings()


def test_phase_timer_registry_matches_jax():
    (got, got_after), (want, want_after) = _registry_run(tprof), _registry_run(jprof)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()} == {
        "outer": 1, "inner": 2, "boom": 1}
    assert got["outer"][0] >= got["inner"][0] >= 0.01
    assert got_after == want_after == {}
    # get_timings hands out copies
    with tprof.phase_timer("x"):
        pass
    tprof.get_timings()["x"].append(1.0)
    assert len(tprof.get_timings()["x"]) == 1
    tprof.reset_timings()


def test_trace_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("MCALF_TORCH_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with tprof.trace() as prof:
        torch.square(torch.arange(4.0))
    assert prof is None and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("how", ("env", "argument"))
def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch, how):
    td = tmp_path / "traces"
    if how == "env":
        monkeypatch.setenv("MCALF_TORCH_TRACE_DIR", str(td))
        arg = None
    else:
        monkeypatch.delenv("MCALF_TORCH_TRACE_DIR", raising=False)
        arg = str(td)
    with tprof.trace(arg) as prof:
        torch.sum(torch.arange(64.0) ** 2)
    files = list(td.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_runner_times_nested_sampling(tmp_path):
    from mcalf_torch.cli import main

    tprof.reset_timings()
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(CFG.format(datadir=TESTDATA, out=tmp_path / "out"))
    assert main([str(cfg)]) == 0
    assert len(tprof.get_timings()["nested_sampling"]) == 1
    tprof.reset_timings()


def test_count_launch_counts_a_captured_launch_per_replay(monkeypatch):
    """A launch outside a capture counts at once; one captured inside
    ``captured_launches`` counts at each replay; one captured outside it
    (a timing graph) counts nothing."""
    counts = {"a": 0, "b": 0}

    def add(key):
        def f(n):
            counts[key] += n
        return f

    add_a, add_b = add("a"), add("b")
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    tprof.count_launch(add_a)
    assert counts == {"a": 1, "b": 0}
    with tprof.captured_launches() as replayed:
        capturing[0] = True
        for _ in range(3):
            tprof.count_launch(add_a)
        tprof.count_launch(add_b)
        capturing[0] = False
        tprof.count_launch(add_b)  # a warm-up call, not captured
    assert counts == {"a": 1, "b": 1}
    replayed()
    replayed()
    assert counts == {"a": 7, "b": 3}
    capturing[0] = True
    tprof.count_launch(add_a)
    assert counts == {"a": 7, "b": 3}
