"""The step-out slice bracket (``NSConfig.bracket = "stepout"``) of the port.

The JAX package's ``_slice_chains_stepout`` (mcalf_tpu/sampler/nested.py)
is ported into the port's one slice body (``_slice_iter``), so the same
iterations run in the eager loop, in the uncaptured blocks and, on a card,
in the captured graph.  Here on the CPU:

* the JAX original against the port on the same draws: the window
  placements, budget splits and per-iteration uniforms that
  ``_slice_chains_stepout`` derives from its key, handed to the port's loop,
  give the same points, log L and evaluations;
* the twin of tests/test_sampler.py::test_stepout_bracket_evidence, at its
  settings and bar (6 seeds, |mean logZ| < 0.27), and both packages' mean
  evaluations per pass on that battery;
* hand-made single iterations: the window placed around t = 0 before each
  end is clamped to the chord, J + K = m - 1, an end at the chord or out of
  budget stops without another test, phases 0 -> 1 -> 2, one draw per
  problem per iteration in every phase;
* the blocks (``_loop="blocks"``) against the eager loop bit for bit, one
  problem and three stacked problems, and a stacked member against its
  solo run;
* ``[ns_settings] bracket = stepout`` through ``mcalf_torch.cli.main``.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcalf_tpu.sampler import nested as jn
from mcalf_torch.cli import main
from mcalf_torch.config import readconfig
from mcalf_torch import runner as trunner
from mcalf_torch.io.chains import read_stats
from mcalf_torch.sampler import NSConfig, finalize, nested_sample
from mcalf_torch.sampler import nested as tn

TESTDATA = Path(__file__).parents[1] / "testdata"


def _gaussian(ndim, sigma, mu=0.5):
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def ll(u):
        r2 = torch.sum((u - mu) ** 2, dim=-1)
        return (norm - 0.5 * r2 / sigma**2).to(torch.float32)

    return ll


# ---- against the JAX original on the same draws ---------------------------


def _jax_bracket(u_cur, d):
    """The cube-chord bracket of the JAX package's slice scheduler (a
    closure there, handed to ``_slice_chains_stepout``), as it is written."""
    safe_d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    c1 = (0.0 - u_cur) / safe_d
    c2 = (1.0 - u_cur) / safe_d
    return jnp.max(jnp.minimum(c1, c2), axis=1), jnp.min(jnp.maximum(c1, c2), axis=1)


@pytest.mark.parametrize("sigma,w,m,ends", [
    (0.1, 0.3, 4, {"budget_lo", "budget_hi"}),             # budgets run out
    (0.3, 1.0, 6, {"chord_lo", "chord_hi"}),               # windows reach the chord
    (0.3, 0.2, 4, {"budget_lo", "budget_hi", "chord_lo"}),  # both
])
def test_iterations_match_the_jax_original(sigma, w, m, ends):
    """``mcalf_tpu.sampler.nested._slice_chains_stepout`` and the port's
    loop on one Gaussian, from the same start points, directions and
    constraint.  The port's step-out pools are JAX's ``split(key, 3)``
    draws (``u01_pool``, ``js_pool``) and each iteration's uniforms its
    ``tu``: the points after the loop agree to float32 rounding (XLA's
    fused arithmetic moves the last bit), the log L likewise, and the
    evaluations exactly, so every chain made the same tests, expansions,
    shrinks and passes."""
    ndim, B, R, seed = 3, 32, 12, 0
    rng = np.random.default_rng(seed)
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def jll(u):
        return (norm - 0.5 * jnp.sum((u - 0.5) ** 2, axis=-1) / sigma**2).astype(jnp.float32)

    def tll(u, prob):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(torch.float32)

    u0 = np.clip(0.5 + rng.normal(0, sigma / 2, (B, ndim)), 0, 1).astype(np.float32)
    l0 = np.array(jll(jnp.asarray(u0)))
    lstar = np.float32(l0.min() - 0.5)
    n = rng.normal(size=(R, B, ndim))
    pool = (0.3 * n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(ndim=ndim, nlive=B, num_repeats=R, bracket="stepout", stepout_w=w,
              stepout_budget=m)
    key = jax.random.PRNGKey(seed)
    ju, jl, _, jn_like = jn._slice_chains_stepout(
        jll, key, jnp.asarray(u0), jnp.asarray(l0), jnp.float32(lstar), jn.NSConfig(**kw),
        jnp.asarray(pool), _jax_bracket, jnp.int32(R))

    key, ku, kj = jax.random.split(key, 3)
    u01 = np.array(jax.random.uniform(ku, (R, B), jnp.float32))
    js = np.array(jax.random.randint(kj, (R, B), 0, m), dtype=np.int32)
    cfg = NSConfig(**kw).resolved()
    x = tn._fixed(tll, [torch.Generator()], torch.from_numpy(pool)[None],
                  torch.tensor([lstar]), [0], cfg,
                  (torch.from_numpy(u01)[None], torch.from_numpy(js)[None]))
    c = tn._init_loop_carry(torch.from_numpy(u0)[None], torch.from_numpy(l0)[None], x)
    seen = set()
    while bool((c.passes < R).any()) and int(c.it_total) < x.total_cap:
        key, kt = jax.random.split(key)
        x.r[0] = torch.from_numpy(np.array(jax.random.uniform(kt, (B,), jnp.float32)))
        shrink = c.phase[0] == 2
        seen |= {name for name, hit in (
            ("phase0", (c.phase[0] == 0).any()), ("phase1", (c.phase[0] == 1).any()),
            ("chord_lo", (shrink & (c.lo[0] <= c.clo[0])).any()),
            ("chord_hi", (shrink & (c.hi[0] >= c.chi[0])).any()),
            ("budget_lo", (shrink & (c.jlo[0] == 0) & (c.lo[0] > c.clo[0])).any()),
            ("budget_hi", (shrink & (c.jhi[0] == 0) & (c.hi[0] < c.chi[0])).any()),
        ) if bool(hit)}
        tn._slice_step(c, x)
    assert {"phase0", "phase1"} | ends <= seen, seen
    assert int(c.n_like[0]) == int(jn_like)
    assert bool((c.passes == R).all())
    np.testing.assert_allclose(c.u[0].numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.logl[0].numpy(), np.asarray(jl), rtol=1e-6, atol=1e-4)


# ---- the JAX package's battery ---------------------------------------------

BATTERY = dict(ndim=4, nlive=100, num_repeats=48, max_samples=4000,
               precision_criterion=1e-3, bracket="stepout")


@pytest.fixture(scope="module")
def battery():
    """tests/test_sampler.py::test_stepout_bracket_evidence's 6 seeds."""
    ll = _gaussian(4, 0.06)
    return [nested_sample(ll, torch.Generator().manual_seed(s), NSConfig(**BATTERY), "cpu")
            for s in range(6)]


def test_stepout_bracket_evidence(battery):
    """tests/test_sampler.py::test_stepout_bracket_evidence's battery and
    bar: a window clamped before it is placed biased it +0.12 nats."""
    zs = [float(r.logz) for r in battery]
    assert abs(np.mean(zs)) < 0.27, zs


def _evals_per_pass(runs):
    cfg = NSConfig(**BATTERY).resolved()
    return (sum(int(r.n_like) for r in runs)
            / sum(int(r.n_iter) * cfg.num_delete * cfg.num_repeats for r in runs))


def test_evaluations_per_pass_match_the_jax_package(battery):
    """The same battery through the JAX package: both packages' mean
    likelihood evaluations per slice pass (about 5.1 on each) within 5 %.
    One seed's rate scatters by about 2 %, so the 6-seed means differ by
    about 1 % from chance alone; an expansion tested twice, or an end not
    stopped at its budget, costs more than the bar."""
    sigma, ndim = 0.06, 4
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def jll(u):
        return (norm - 0.5 * jnp.sum((u - 0.5) ** 2, axis=-1) / sigma**2).astype(jnp.float32)

    ref = [jn.nested_sample(jll, jax.random.PRNGKey(s), jn.NSConfig(**BATTERY))
           for s in range(6)]
    port, want = _evals_per_pass(battery), _evals_per_pass(ref)
    assert 4.0 < want < 7.0
    assert abs(port / want - 1.0) < 0.05, (port, want)


# ---- one iteration by hand -------------------------------------------------

W, M = 2.0, 16


def _one_chain(u0, d, u01, js, lstar=-1.0, nrep=2, ll=None):
    """One problem, one chain at ``u0`` along direction ``d`` on every
    pass, with the step-out pools given; the likelihood records the points
    it is asked for (0 everywhere unless ``ll`` says otherwise)."""
    asked = []

    def rows(u, prob):
        asked.append(u.clone())
        return torch.zeros(u.shape[0]) if ll is None else ll(u)

    ndim = len(u0)
    cfg = NSConfig(ndim=ndim, num_repeats=nrep, bracket="stepout", stepout_w=W,
                   stepout_budget=M).resolved()
    pools = torch.tensor(d, dtype=torch.float32).expand(1, nrep, 1, ndim).clone()
    so = (torch.full((1, nrep, 1), u01, dtype=torch.float32),
          torch.full((1, nrep, 1), js, dtype=torch.int32))
    x = tn._fixed(rows, [torch.Generator().manual_seed(0)], pools,
                  torch.tensor([lstar]), [0], cfg, so)
    u = torch.tensor([[u0]], dtype=torch.float32)
    c = tn._init_loop_carry(u, torch.zeros((1, 1)), x)
    return c, x, asked


def test_window_placed_before_clamping():
    # chord along d = 0.5 e0 from u = 0.1: t in [-0.2, 1.8]; the window
    # [-u01 w, -u01 w + w] = [-0.5, 1.5] is placed first, then each end is
    # clamped on its own: [-0.2, 1.5], not [-0.2, min(-0.2 + w, 1.8)]
    c, x, _ = _one_chain([0.1, 0.5], [0.5, 0.0], u01=0.25, js=3)
    assert isinstance(c, tn._StepoutCarry)
    assert c.clo.item() == pytest.approx(-0.2) and c.chi.item() == pytest.approx(1.8)
    assert c.lo.item() == pytest.approx(-0.2)
    assert c.hi.item() == pytest.approx(1.5)
    # the low end sits at the chord: not tested, the pass starts at its high end
    assert int(c.jlo) == 3 and int(c.jhi) == M - 1 - 3
    assert int(c.phase) == 1


def test_budget_split_sums_to_m_minus_one():
    cfg = NSConfig(ndim=3, num_repeats=40, bracket="stepout", stepout_budget=M).resolved()
    u01, js = tn._stepout_pools(torch.Generator().manual_seed(1), cfg, 64, "cpu")
    assert u01.shape == js.shape == (40, 64) and js.dtype == torch.int32
    assert int(js.min()) == 0 and int(js.max()) == M - 1
    assert bool(((u01 >= 0) & (u01 < 1)).all())
    rng = np.random.default_rng(2)
    u0 = torch.tensor(rng.uniform(0.2, 0.8, (1, 64, 3)), dtype=torch.float32)
    pools = torch.tensor(rng.normal(0, 0.1, (1, 40, 64, 3)), dtype=torch.float32)
    x = tn._fixed(lambda u, p: torch.zeros(u.shape[0]), [torch.Generator()], pools,
                  torch.tensor([-1.0]), [0], cfg, (u01[None], js[None]))
    c = tn._init_loop_carry(u0, torch.zeros((1, 64)), x)
    assert torch.equal(c.jlo + c.jhi, torch.full((1, 64), M - 1, dtype=torch.int32))
    assert x.total_cap == 40 * (cfg.max_shrink + M + 2)
    assert tn._stepout_pools(torch.Generator(), NSConfig(ndim=3).resolved(), 4, "cpu") is None


def test_phases_and_ends_stopped_without_a_test():
    # d = 0.1 e0 from u = 0.5: chord t in [-5, 5]; window [-1, 1]; one
    # expansion to the low end (J = 1), 14 to the high end.  Every point is
    # in the slice.  Low end: test -1, move to -3, budget spent: done
    # without testing -3.  High end: test 1 -> 3, test 3 -> 5 = the chord:
    # done without testing 5.  Then one shrink proposal, accepted.
    c, x, asked = _one_chain([0.5, 0.5], [0.1, 0.0], u01=0.5, js=1)
    phases, tested = [int(c.phase)], []
    gen0 = torch.Generator().manual_seed(0)
    for i in range(4):
        tn._slice_iter(c, x)
        tested.append(round((asked[-1][0, 0].item() - 0.5) / 0.1, 4))
        last = asked[-1][0, 0].item()
        phases.append(int(c.phase))
        # one (B,) draw per problem per iteration, in every phase
        want = torch.rand((1,), generator=gen0)
        assert torch.equal(x.r[0], want) and torch.equal(
            x.gens[0].get_state(), gen0.get_state())
    assert tested[:3] == [-1.0, 1.0, 3.0]
    assert -3.0 <= tested[3] <= 5.0
    assert phases[:4] == [0, 1, 1, 2]
    assert c.passes.tolist() == [[1]] and c.it_pass.tolist() == [[0]]
    # the accepted point starts the next pass, around itself
    assert c.u[0, 0, 0].item() == last
    assert int(c.phase) == 0 and c.n_like.tolist() == [4]


def test_end_outside_the_slice_stops_and_shrink_rejects():
    # the slice is |t| < 1.5 along d = 0.1 e0: the low end's test at -1 is
    # inside (move to -3), its test at -3 outside (stop there); the high
    # end likewise; then shrinkage inside [-3, 3]
    def ll(u):
        return torch.where((u[:, 0] - 0.5).abs() < 0.15, 0.0, -2.0)

    c, x, asked = _one_chain([0.5, 0.5], [0.1, 0.0], u01=0.5, js=5, ll=ll)
    for _ in range(4):
        tn._slice_iter(c, x)
    tested = [round((a[0, 0].item() - 0.5) / 0.1, 4) for a in asked]
    assert tested == [-1.0, -3.0, 1.0, 3.0]
    assert (c.lo.item(), c.hi.item()) == (pytest.approx(-3.0), pytest.approx(3.0))
    assert int(c.phase) == 2 and (int(c.jlo), int(c.jhi)) == (4, 9)
    for _ in range(40):
        tn._slice_iter(c, x)
        if int(c.passes) == 1:
            break
    assert int(c.passes) == 1
    # shrinkage never left the window [-3, 3]
    assert all(-3.0 <= t <= 3.0 for t in
               [round((a[0, 0].item() - 0.5) / 0.1, 4) for a in asked[4:]])


def test_unknown_bracket_raises():
    cfg = NSConfig(ndim=2, nlive=20, bracket="fixed")
    with pytest.raises(ValueError, match="unknown bracket 'fixed'"):
        nested_sample(_gaussian(2, 0.1), torch.Generator(), cfg, "cpu")


# ---- the loops and the fleet, bit for bit ----------------------------------

NDIM, B, R = 5, 16, 10
SO_CFG = NSConfig(ndim=NDIM, num_repeats=R, bracket="stepout", stepout_w=0.5,
                  stepout_budget=4).resolved()


def _rows_gauss(mus, sig=0.1):
    mus = torch.tensor(np.asarray(mus), dtype=torch.float32)

    def ll(u, prob):
        d = (u - mus[prob.long()]) / sig
        out = torch.zeros(u.shape[0])
        for j in range(u.shape[1]):
            out = out + d[:, j] * d[:, j]
        return -0.5 * out

    return ll


def _problem(Q, seed=0):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(0.3, 0.7, (3, NDIM))[:Q]
    ll = _rows_gauss(mus)
    u = torch.tensor(
        np.clip(mus[:, None, :] + rng.normal(0, 0.05, (Q, B, NDIM)), 0, 1), dtype=torch.float32
    )
    logl = ll(u.reshape(-1, NDIM), torch.arange(Q).repeat_interleave(B)).reshape(Q, B)
    lstar = logl.min(dim=1).values - torch.tensor([0.01, 0.5, 5.0])[:Q]
    n = rng.normal(size=(3, R, B, NDIM))[:Q]
    pools = torch.tensor(0.3 * n / np.linalg.norm(n, axis=-1, keepdims=True), dtype=torch.float32)
    so = (torch.tensor(rng.uniform(size=(3, R, B)), dtype=torch.float32)[:Q],
          torch.tensor(rng.integers(0, 4, (3, R, B)), dtype=torch.int32)[:Q])
    return ll, u, logl, pools, lstar, so


def _run(loop, Q, k, monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", k)
    ll, u, logl, pools, lstar, so = _problem(Q)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)[:Q]]
    out = tn._slice_stacked(ll, gens, u, logl, pools, lstar, SO_CFG, list(range(Q)),
                            loop=loop, so_pools=so)
    return out, [g.get_state() for g in gens]


@pytest.mark.parametrize("k", (1, 7, 32))
@pytest.mark.parametrize("Q", (1, 3))
def test_blocks_match_the_eager_loop(Q, k, monkeypatch):
    (u, logl, n), states = _run("blocks", Q, k, monkeypatch)
    (ue, logle, ne), states_e = _run("eager", Q, k, monkeypatch)
    assert torch.equal(u, ue) and torch.equal(logl, logle)
    assert n == ne
    assert all(torch.equal(a, b) for a, b in zip(states, states_e))
    if Q == 3:  # the members finish at different iterations
        assert len(set(n)) >= 2


def _small_cfg(bracket="stepout"):
    return NSConfig(ndim=4, nlive=40, num_repeats=6, max_samples=600,
                    precision_criterion=1e-2, bracket=bracket)


def _problems():
    return [(0.5, 0.08), (0.4, 0.06), (0.6, 0.1)]


def _stacked_ll(probs):
    lls = [_gaussian(4, s, mu) for mu, s in probs]

    def rows(u, prob):
        out = torch.empty(u.shape[0])
        for q, f in enumerate(lls):
            sel = prob == q
            if bool(sel.any()):
                out[sel] = f(u[sel])
        return out

    return rows


@pytest.mark.parametrize("loop", ("eager", "blocks"))
def test_stacked_member_is_its_solo_run(loop, monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", 7)
    cfg = _small_cfg()
    probs = _problems()
    finals = tn.nested_sample_stacked(
        _stacked_ll(probs), [torch.Generator().manual_seed(10 + q) for q in range(3)],
        cfg, "cpu", _loop=loop,
    )
    for q, (mu, s) in enumerate(probs):
        solo = nested_sample(_gaussian(4, s, mu), torch.Generator().manual_seed(10 + q),
                             cfg, "cpu", _loop="eager")
        got = finalize(finals[q], cfg)
        assert torch.equal(got.samples_u, solo.samples_u), q
        assert torch.equal(got.logl, solo.logl) and got.logz == solo.logz
        assert got.n_like == solo.n_like and got.n_iter == solo.n_iter


def test_stepout_differs_from_the_chord():
    ll = _gaussian(4, 0.08)
    so = nested_sample(ll, torch.Generator().manual_seed(3), _small_cfg(), "cpu")
    chord = nested_sample(ll, torch.Generator().manual_seed(3), _small_cfg("chord"), "cpu")
    assert so.n_like != chord.n_like
    assert not torch.equal(so.samples_u, chord.samples_u)


# ---- through the CLI ------------------------------------------------------

CLI_CFG = """
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata}/
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
{extra}
"""


def test_cli_stepout_bracket(tmp_path):
    out = {}
    for name, extra in (("stepout", "bracket = stepout\nstepout_w = 1.5\nstepout_budget = 8"),
                        ("chord", "")):
        d = tmp_path / name
        d.mkdir()
        cfgfile = d / "fit.cfg"
        cfgfile.write_text(CLI_CFG.format(testdata=TESTDATA, out=d, extra=extra))
        cp = readconfig(str(cfgfile))
        plan = trunner.solver_nsconfig(cp, 4)
        assert plan.cfg.bracket == name
        if name == "stepout":
            assert (plan.cfg.stepout_w, plan.cfg.stepout_budget) == (1.5, 8)
        assert main([str(cfgfile)]) == 0
        base = trunner.chain_basename(cp)
        lnz, err = read_stats(base + ".stats")
        rows = np.loadtxt(base + "_equal_weights.txt")
        assert math.isfinite(lnz) and err >= 0 and rows.shape[1] == 2 + 4
        out[name] = (Path(base + ".stats").read_bytes(), lnz)
    assert out["stepout"][0] != out["chord"][0]
    # stopped at its cap far from convergence: the run's logZ is a lower
    # bound of the quadrature value 4985.51, as the chord's
    assert out["stepout"][1] < 4985.51 + 1.0
