"""The slice loop in blocks of k iterations, as a CUDA graph replays it,
run here uncaptured on the CPU (``_loop="blocks"``) against the eager loop.

* Blocks of k = 1, 7 and 32 give the eager loop's (u, logl, n_evals) bit for
  bit, one problem and a 3-problem fleet whose members finish in different
  blocks, and leave every generator where the eager loop leaves it.
* The cap of num_repeats * max_shrink iterations holds inside a block; a
  problem that is done moves neither its carry nor its counters.
* The first num_repeats // k blocks run without a host read, then one read
  per block.
* A run keeps the blocks (on a card, the graph and its memory pool) of
  the set of problems stepping now, and of no set before it.
* The whole sampler in blocks gives the solo run's stored regression values
  and a fleet's eager results.
The captured graph itself runs only on a card: tests/test_torch_graph_gpu.py.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.sampler import NSConfig, finalize, nested_sample
from mcalf_torch.sampler import nested as tn
from mcalf_torch.sampler.graph import stats

TESTDATA = Path(__file__).parents[1] / "testdata"
_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], specres=[8.0],
    Nrange=[12.0, 14.5], zrange=[2.99, 3.01], brange=[10.0, 40.0],
)
#: tests/test_torch_fleet.py's SOLO_REFERENCE["1comp"]: the solo run's logZ
#: (float hex), n_like, outer steps and digest of samples_u + logl at
#: generator seed 5, recorded on the eager loop before the problem axis
SOLO_1COMP = ("0x1.379bac0000000p+12", 30220, 39,
              "03662b092432dc2e376703df78e66386165549188defe1df96240c120ba61af1")

NDIM, B, R = 5, 16, 10
CFG = NSConfig(ndim=NDIM, num_repeats=R).resolved()


def _gauss(mus, sig=0.1):
    """Stacked isotropic Gaussians, problem q centred on mus[q]; each row's
    value is computed alone (a sum over columns in a fixed order), so it
    does not depend on the rest of the batch."""
    mus = torch.tensor(np.asarray(mus), dtype=torch.float32)

    def ll(u, prob):
        d = (u - mus[prob.long()]) / sig
        out = torch.zeros(u.shape[0])
        for j in range(u.shape[1]):
            out = out + d[:, j] * d[:, j]
        return -0.5 * out

    return ll


def _problem(Q, seed=0):
    """Q problems' likelihood, starts, direction pools and constraints; the
    constraints are tight, medium and loose, so the problems finish after
    38, 42 and 31 iterations (in different blocks of 7 and of 32)."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(0.3, 0.7, (3, NDIM))[:Q]
    ll = _gauss(mus)
    u = torch.tensor(
        np.clip(mus[:, None, :] + rng.normal(0, 0.05, (Q, B, NDIM)), 0, 1), dtype=torch.float32
    )
    logl = ll(u.reshape(-1, NDIM), torch.arange(Q).repeat_interleave(B)).reshape(Q, B)
    lstar = logl.min(dim=1).values - torch.tensor([0.01, 0.5, 5.0])[:Q]
    n = rng.normal(size=(3, R, B, NDIM))[:Q]
    pools = torch.tensor(0.3 * n / np.linalg.norm(n, axis=-1, keepdims=True), dtype=torch.float32)
    return ll, u, logl, pools, lstar


def _gens(Q):
    return [torch.Generator().manual_seed(s) for s in (1, 2, 3)[:Q]]


def _run(loop, Q, k, monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", k)
    ll, u, logl, pools, lstar = _problem(Q)
    gens = _gens(Q)
    out = tn._slice_stacked(ll, gens, u, logl, pools, lstar, CFG, list(range(Q)), loop=loop)
    return out, [g.get_state() for g in gens]


@pytest.mark.parametrize("k", (1, 7, 32))
@pytest.mark.parametrize("Q", (1, 3))
def test_blocks_match_the_eager_loop(Q, k, monkeypatch):
    (u, logl, n), states = _run("blocks", Q, k, monkeypatch)
    (ue, logle, ne), states_e = _run("eager", Q, k, monkeypatch)
    assert torch.equal(u, ue) and torch.equal(logl, logle)
    assert n == ne
    assert all(torch.equal(a, b) for a, b in zip(states, states_e))
    # the generators moved: the eager loop drew one (B,) batch per iteration
    assert not any(torch.equal(a, g.get_state()) for a, g in zip(states, _gens(Q)))


@pytest.mark.parametrize("k", (7, 32))
def test_fleet_members_finish_in_different_blocks(k, monkeypatch):
    (_, _, n), _ = _run("eager", 3, k, monkeypatch)
    iterations = [x // B for x in n]
    assert iterations == [38, 42, 31]
    assert len({i // k for i in iterations}) >= 2


def _carry(Q=2):
    ll, u, logl, pools, lstar = _problem(Q)
    x = tn._fixed(ll, _gens(Q), pools, lstar, list(range(Q)), CFG)
    return tn._init_carry(u, logl, pools), x


def _clone(c):
    return tn._Carry(*(t.clone() for t in c))


def test_cap_holds_inside_a_block():
    c, x = _carry()
    c.it_total.fill_(x.total_cap - 3)
    want = _clone(c)
    tn._block(c, x, 7)
    x2 = tn._fixed(x.loglike_rows, _gens(2), x.pools, x.lstar, [0, 1], CFG)
    for _ in range(3):
        tn._slice_iter(want, x2)
    for name, a, b in zip(tn._Carry._fields, c, want):
        if name != "it_total":
            assert torch.equal(a, b), name
    assert int(c.it_total) == x.total_cap + 4
    assert x.status[0].tolist() == [0, 0]
    assert x.status[1].tolist() == [3 * B, 3 * B]
    assert x.total_cap == R * CFG.max_shrink


def test_finished_problem_does_not_move():
    c, x = _carry()
    c.passes[1].fill_(R)  # problem 1 has made its passes
    before = _clone(c)
    tn._block(c, x, 7)
    for name, a, b in zip(tn._Carry._fields, c, before):
        if name == "it_total":
            assert int(a) == 7
        elif name == "n_like":
            assert a.tolist() == [7 * B, 0]
        else:
            assert torch.equal(a[1], b[1]), name
    # every chain of problem 0 accepted (u moved) or shrank its bracket
    moved = (c.u[0] != before.u[0]).any(dim=-1) | (c.lo[0] != before.lo[0]) | (
        c.hi[0] != before.hi[0])
    assert bool(moved.all())
    assert x.status[0].tolist() == [1, 0]


@pytest.mark.parametrize("k", (1, 3, 7, 32))
def test_no_read_before_num_repeats_iterations(k):
    c, x = _carry()
    reads = []

    def run_block():
        reads.append(stats["reads"])
        tn._block(c, x, k)

    start = stats["reads"]
    status, blocks = tn._block_loop(x, k, run_block)
    reads = [r - start for r in reads]
    quiet = R // k
    assert reads[: quiet + 1] == [0] * (quiet + 1)
    assert reads[quiet + 1:] == list(range(1, len(reads) - quiet))
    assert stats["reads"] - start == len(reads) - quiet
    assert status == x.status.tolist() and blocks == len(reads)
    assert status[1] == c.n_like.tolist() and not any(status[0])


def test_loop_choice():
    assert tn._loop_kind(torch.device("cpu"), None) == "eager"
    assert tn._loop_kind(torch.device("cuda"), None) == "graph"
    assert tn._loop_kind(torch.device("cuda"), "eager") == "eager"
    with pytest.raises(ValueError, match="CUDA device"):
        tn._loop_kind(torch.device("cpu"), "graph")
    with pytest.raises(ValueError, match="unknown slice loop"):
        tn._loop_kind(torch.device("cpu"), "while")


def test_a_run_keeps_one_set_of_blocks(monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", 7)
    ll, u, logl, pools, lstar = _problem(3)
    gens, graphs = _gens(3), {}
    tn._slice_stacked(ll, gens, u, logl, pools, lstar, CFG, [0, 1, 2], loop="blocks",
                      graphs=graphs)
    [first] = graphs.values()
    tn._slice_stacked(ll, gens, u, logl, pools, lstar, CFG, [0, 1, 2], loop="blocks",
                      graphs=graphs)
    assert list(graphs.values()) == [first]  # the same set steps again: kept
    tn._slice_stacked(ll, gens[:2], u[:2], logl[:2], pools[:2], lstar[:2], CFG, [0, 1],
                      loop="blocks", graphs=graphs)
    assert len(graphs) == 1 and first not in graphs.values()


def _model(spec="civ_mock_spec.txt"):
    return AbsorptionModel.from_file(str(TESTDATA / spec), ncomp=(1, 1), **_CIV)


def test_blocks_give_the_stored_solo_regression(monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", 7)
    m = _model()
    cfg = NSConfig(ndim=m.ndim, canon_layout=m.canon_layout(), nlive=40, num_repeats=4,
                   max_samples=2000)
    gen = torch.Generator().manual_seed(5)
    r = nested_sample(make_torch_forward(m, "cpu").loglike_cube, gen, cfg, "cpu", _loop="blocks")
    digest = hashlib.sha256(
        np.ascontiguousarray(r.samples_u.numpy()).tobytes()
        + np.ascontiguousarray(r.logl.numpy()).tobytes()
    ).hexdigest()
    assert (float(r.logz).hex(), r.n_like, r.n_iter, digest) == SOLO_1COMP


@pytest.mark.parametrize("k", (7, 32))
def test_blocks_fleet_matches_the_eager_fleet(k, monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", k)
    cfg = NSConfig(ndim=3, nlive=30, num_repeats=6, max_samples=3000)
    ll = _gauss(np.random.default_rng(1).uniform(0.3, 0.7, (3, 3)), sig=0.05)
    runs = {}
    for loop in ("eager", "blocks"):
        gens = _gens(3)
        finals = tn.nested_sample_stacked(ll, gens, cfg, "cpu", chunk_steps=5, _loop=loop)
        runs[loop] = [finalize(f, cfg) for f in finals], [g.get_state() for g in gens]
    (eager, ge), (blocks, gb) = runs["eager"], runs["blocks"]
    assert len({r.n_iter for r in eager}) > 1  # the members end at different steps
    for a, b in zip(eager, blocks):
        assert (a.n_like, a.n_iter) == (b.n_like, b.n_iter)
        assert torch.equal(a.logz, b.logz) and torch.equal(a.samples_u, b.samples_u)
        assert torch.equal(a.logl, b.logl)
    assert all(torch.equal(a, b) for a, b in zip(ge, gb))


def test_blocks_through_the_runner_model_on_the_cpu(monkeypatch):
    """A stacked likelihood of the port's model (the plain fused path) in
    blocks: the same chains as the eager loop."""
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward

    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", 7)
    models = [_model(), _model("civ_mock_spec_multicomp.txt")]
    sf = make_stacked_forward(*stack_problems(models), "cpu")
    cfg = NSConfig(ndim=4, nlive=20, num_repeats=3, max_samples=80)
    out = {}
    for loop in ("eager", "blocks"):
        gens = _gens(2)
        out[loop] = [finalize(f, cfg) for f in tn.nested_sample_stacked(
            sf.loglike_cube, gens, cfg, "cpu", _loop=loop)]
    for a, b in zip(out["eager"], out["blocks"]):
        assert a.n_like == b.n_like and torch.equal(a.samples_u, b.samples_u)
        assert torch.equal(a.logl, b.logl)
