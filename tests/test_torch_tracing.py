"""The port's phase spans and the slice loop's row counters
(``mcalf_torch/utils/profiling.py``, ``mcalf_torch/sampler/graph.py``).

* A 2-seed CPU fleet through ``cli.main`` records each span the number of
  times its place in the code runs, the sampler's spans inside the
  ``nested_sampling`` one; under ``--debug`` it prints the counters per
  seed and the seconds of each span, and every file it writes is the one
  it writes without ``--debug`` (counting off), byte for byte.
* Under ``trace()`` each span is a ``user_annotation`` of the Chrome trace,
  inside ``nested_sampling``, and the slice loop's draws fall inside
  ``sampler.slice_loop``.
* With counting on, the eager and the blocks loops count the rows they
  evaluate and the rows with a pass to make as a host-side count of
  ``running`` does, and move no bit of the chains, the evaluations or the
  generators.  With counting off, one block issues the ops it issued
  before the counters existed.
The captured loop's counters run only on a card: tests/test_torch_graph_gpu.py.
"""

import json
from collections import Counter
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mcalf_torch.sampler import NSConfig
from mcalf_torch.sampler import graph
from mcalf_torch.sampler import nested as tn
from mcalf_torch.utils import profiling as tprof

TESTDATA = Path(__file__).parents[1] / "testdata"
SEEDS = (3, 4)
#: outer steps of each capped fit: max_samples / num_delete (nlive 40)
STEPS = 4
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
seeds = {seeds}

[ns_settings]
nlive = 40
num_repeats = 4
max_samples = {cap}
precision_criterion = 0.01
"""
#: the spans of one fit and how often each runs
SPANS = {
    "nested_sampling": 1,
    "sampler.init": 1,
    "sampler.step": STEPS,
    "sampler.slice_loop": STEPS,
    # one pass of the host loop per outer step, one that finds every
    # problem capped, one that finds them done
    "sampler.boundary": STEPS + 2,
    "sampler.recluster": len(SEEDS),
    "sampler.finalize": len(SEEDS),
    "runner.merge": 1,
    "runner.files": len(SEEDS) + 1,
}


def _since(before):
    return {k: v[len(before.get(k, [])):] for k, v in tprof.get_timings().items()
            if len(v) > len(before.get(k, []))}


def _fit(tmp, tag, debug=False):
    from mcalf_torch.cli import main

    cfg = tmp / f"{tag}.cfg"
    cfg.write_text(CFG.format(datadir=TESTDATA, out=tmp / tag, cap=20 * STEPS,
                              seeds=",".join(map(str, SEEDS))))
    before, rows = tprof.get_timings(), dict(graph.stats)
    out = StringIO()
    with redirect_stdout(out):
        assert main([str(cfg)] + (["--debug"] if debug else [])) == 0
    return dict(spans=_since(before), out=out.getvalue(), dir=tmp / tag,
                rows={k: graph.stats[k] - rows[k] for k in ("rows", "rows_active")})


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing")
    return {"plain": _fit(tmp, "plain"), "debug": _fit(tmp, "debug", debug=True)}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_cli_records_each_span(fits, name):
    for f in fits.values():
        assert len(f["spans"].get(name, [])) == SPANS[name], name
    assert set(fits["plain"]["spans"]) == set(SPANS)


def test_sampler_spans_lie_inside_nested_sampling(fits):
    s = {k: sum(v) for k, v in fits["plain"]["spans"].items()}
    outer = ("sampler.init", "sampler.step", "sampler.boundary", "sampler.finalize")
    assert sum(s[k] for k in outer) <= s["nested_sampling"]
    assert s["sampler.slice_loop"] <= s["sampler.step"]
    assert s["sampler.recluster"] <= s["sampler.boundary"]


def test_counting_is_off_by_default_and_debug_restores_it(fits):
    assert not tprof.counters_enabled()
    assert fits["plain"]["rows"]["rows"] > 0 and fits["plain"]["rows"]["rows_active"] == 0
    # the CPU's eager loop evaluates a problem's rows while it has a chain
    # with a pass to make, and some chains of it wait for the others
    rows, active = fits["debug"]["rows"]["rows"], fits["debug"]["rows"]["rows_active"]
    assert rows == fits["plain"]["rows"]["rows"] and 0 < active < rows


def test_debug_prints_the_counters_and_the_spans(fits):
    out = fits["debug"]["out"]
    for s in SEEDS:
        [line] = [ln for ln in out.splitlines() if ln.startswith(f"[DEBUG]: seed {s}:")]
        assert "proposals per slice pass" in line and "rows masked" in line
    for name, n in SPANS.items():
        assert f"[DEBUG]: span {name}: {n} x, " in out
    assert "proposals per slice pass" not in fits["plain"]["out"]


def test_debug_prints_the_fused_launches(fits):
    """One line of the fit's fused-kernel launches, those of them made
    from the unit cube, their (row, transition) pairs and damped ones, the
    damped ones' pixels that took the 916 series, and the slice kernels'
    iterations: none on the CPU, whose glue and slice bookkeeping run in
    PyTorch."""
    lines = [ln for ln in fits["debug"]["out"].splitlines()
             if ln.startswith("[DEBUG]: fused-kernel launches")]
    assert lines == ["[DEBUG]: fused-kernel launches 0, 0 of them from the unit cube; "
                     "lines 0, hjert_lines 0, series_evals 0; slice_update launches 0"]
    assert "fused-kernel launches" not in fits["plain"]["out"]


def test_counting_leaves_every_file_byte_for_byte(fits):
    plain = sorted(p.relative_to(fits["plain"]["dir"]) for p in fits["plain"]["dir"].rglob("*")
                   if p.is_file())
    debug = sorted(p.relative_to(fits["debug"]["dir"]) for p in fits["debug"]["dir"].rglob("*")
                   if p.is_file())
    assert plain == debug and len(plain) == 2 * (len(SEEDS) + 1)
    for rel in plain:
        assert (fits["plain"]["dir"] / rel).read_bytes() == (fits["debug"]["dir"] / rel).read_bytes()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traced")
    with tprof.trace(str(tmp / "trace")):
        fit = _fit(tmp, "fit")
    [path] = (tmp / "trace").glob("*.pt.trace.json")
    return fit, json.loads(path.read_text())["traceEvents"]


def _annotations(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] == name]


def test_trace_annotates_every_span_inside_nested_sampling(traced):
    fit, events = traced
    [(lo, hi)] = _annotations(events, "nested_sampling")
    for name, n in SPANS.items():
        spans = _annotations(events, name)
        assert len(spans) == n == len(fit["spans"][name]), name
        if name.startswith("sampler."):
            assert all(lo <= a and b <= hi for a, b in spans), name


def test_trace_puts_the_loop_draws_inside_the_slice_loop(traced):
    """The eager loop draws one (B,) batch per iteration for each problem
    with a pass to make: as many ``aten::rand`` calls inside the
    ``sampler.slice_loop`` spans as rows evaluated over B."""
    fit, events = traced
    loops = _annotations(events, "sampler.slice_loop")
    steps = _annotations(events, "sampler.step")
    assert all(any(a <= c and d <= b for a, b in steps) for c, d in loops)
    rand = [e["ts"] for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::rand"]
    inside = sum(any(a <= t <= b for a, b in loops) for t in rand)
    assert inside == fit["rows"]["rows"] // 20  # num_delete = nlive / 2
    assert len(rand) > inside  # the heads' and tails' draws lie outside


# --- the counters on the loop itself ------------------------------------

NDIM, B, R = 4, 12, 6


def _gauss(mus, sig=0.1):
    """Stacked isotropic Gaussians; each row's value is computed alone."""
    mus = torch.tensor(np.asarray(mus), dtype=torch.float32)

    def ll(u, prob):
        d = (u - mus[prob.long()]) / sig
        out = torch.zeros(u.shape[0])
        for j in range(u.shape[1]):
            out = out + d[:, j] * d[:, j]
        return -0.5 * out

    return ll


def _gens(Q):
    return [torch.Generator().manual_seed(11 + q) for q in range(Q)]


def _problem(Q, bracket):
    """Q problems' likelihood, starts, pools and tight to loose constraints,
    so that the problems finish after different numbers of iterations."""
    cfg = NSConfig(ndim=NDIM, nlive=2 * B, num_delete=B, num_repeats=R,
                   bracket=bracket, stepout_budget=4).resolved()
    rng = np.random.default_rng(7)
    mus = rng.uniform(0.3, 0.7, (Q, NDIM))
    ll = _gauss(mus)
    u = torch.tensor(np.clip(mus[:, None] + rng.normal(0, 0.05, (Q, B, NDIM)), 0, 1),
                     dtype=torch.float32)
    logl = ll(u.reshape(-1, NDIM), torch.arange(Q).repeat_interleave(B)).reshape(Q, B)
    lstar = logl.min(dim=1).values - torch.tensor([0.01, 0.5, 5.0])[:Q]
    n = rng.normal(size=(Q, R, B, NDIM))
    pools = torch.tensor(0.3 * n / np.linalg.norm(n, axis=-1, keepdims=True),
                         dtype=torch.float32)
    so = None
    if bracket == "stepout":
        draws = [tn._stepout_pools(torch.Generator().manual_seed(99 + q), cfg, B, "cpu")
                 for q in range(Q)]
        so = tuple(torch.stack(t) for t in zip(*draws))
    return cfg, ll, u, logl, pools, lstar, so


@pytest.fixture
def counting():
    was = tprof.enable_counters(True)
    yield
    tprof.enable_counters(was)


def _host_count(Q, bracket, k=None):
    """Iterations run and active rows, counted on the host one iteration at
    a time from ``running`` as ``_slice_step`` forms it; with k, the loop
    runs on in blocks of k as ``_block_loop`` does."""
    cfg, ll, u, logl, pools, lstar, so = _problem(Q, bracket)
    x = tn._fixed(ll, _gens(Q), pools, lstar, list(range(Q)), cfg, so)
    c = tn._init_loop_carry(u, logl, x)
    active, its = [0] * Q, 0
    while True:
        running = (c.passes < x.nrep) & (c.it_total < x.total_cap)
        if k is None and not bool(running.any()):
            return its, active
        if k is not None and its % k == 0 and its // k > x.nrep // k and not bool(running.any()):
            return its, active
        active = [a + int(n) for a, n in zip(active, running.sum(dim=1))]
        tn._slice_iter(c, x)
        its += 1


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
@pytest.mark.parametrize("loop", ("eager", "blocks"))
def test_counting_matches_a_host_count_and_moves_no_bit(loop, bracket, counting, monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", 5)
    Q = 3
    cfg, ll, u, logl, pools, lstar, so = _problem(Q, bracket)
    out = {}
    for on in (False, True):
        tprof.enable_counters(on)
        gens, before = _gens(Q), dict(graph.stats)
        res = tn._slice_stacked(ll, gens, u, logl, pools, lstar, cfg, list(range(Q)),
                                loop=loop, so_pools=so)
        out[on] = res, [g.get_state() for g in gens], {
            k: graph.stats[k] - before[k] for k in ("rows", "rows_active")}, gens
    (u0, l0, n0), s0, c0, _ = out[False]
    (u1, l1, n1), s1, c1, gens = out[True]
    assert torch.equal(u0, u1) and torch.equal(l0, l1) and n0 == n1
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    its, active = _host_count(Q, bracket, None if loop == "eager" else 5)
    assert c1["rows_active"] == sum(active) and c0["rows_active"] == 0
    assert [graph.generator_rows(g)[1] for g in gens] == active
    if loop == "eager":  # a problem's rows leave the batch with its last pass
        assert c0["rows"] == c1["rows"] == sum(n1)
    else:
        assert c0["rows"] == c1["rows"] == its * Q * B
        assert its % 5 == 0 and max(n1) <= its * B
    assert len(set(n1)) == Q  # the problems finish after different iterations


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _block_ops(bracket, k=7, Q=2):
    cfg, ll, u, logl, pools, lstar, so = _problem(Q, bracket)
    x = tn._fixed(ll, _gens(Q), pools, lstar, list(range(Q)), cfg, so)
    c = tn._init_loop_carry(u, logl, x)
    with _Ops() as m:
        tn._block(c, x, k)
    return sum(m.ops.values())


#: the ops one block of 7 iterations of _block_ops' problem issued before
#: the counters existed (counted on that tree with this function)
PARENT_BLOCK_OPS = {"chord": 715, "stepout": 1303}


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_counting_off_block_issues_the_ops_it_did_before(bracket):
    assert not tprof.counters_enabled()
    assert _block_ops(bracket) == PARENT_BLOCK_OPS[bracket]


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_counting_on_adds_one_op_per_iteration(bracket, counting):
    # per iteration the add of the running mask; once per block the sum
    # over each problem's chains, the status row's select and the copy
    assert _block_ops(bracket) == PARENT_BLOCK_OPS[bracket] + 7 + 3


def test_enable_counters_returns_the_previous_setting():
    assert tprof.enable_counters(True) is False
    assert tprof.counters_enabled()
    assert tprof.enable_counters(False) is True
    assert not tprof.counters_enabled()


def test_phase_timer_yields_its_duration():
    before = tprof.get_timings()
    with tprof.phase_timer("tracing.test") as span:
        torch.ones(8).sum()
    assert span.seconds > 0 and _since(before)["tracing.test"] == [span.seconds]


def test_row_counts_survive_threads():
    """A fleet's blocks on several local devices count from their own host
    threads: no row and no problem's tally is lost between them."""
    import sys
    import threading

    gens = [torch.Generator() for _ in range(4)]
    before = dict(graph.stats)

    def work():
        for _ in range(500):
            graph.count_rows(gens, [3, 3, 3, 3], [1, 2, 0, 1])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = 16 * 500
    assert graph.stats["rows"] - before["rows"] == 12 * n
    assert graph.stats["rows_active"] - before["rows_active"] == 4 * n
    assert [graph.generator_rows(g) for g in gens] == [(3 * n, a * n) for a in (1, 2, 0, 1)]
