"""The fleet on the CPU: several problems through one stacked sampler loop.

* Fleet member i is bit for bit the solo ``nested_sample`` of problem i with
  generator i (logZ, samples, likelihood count), also when the members
  finish at different steps; and the solo sampler itself is bit for bit
  what it was before the problem axis existed (stored regression values).
* A chunked fleet resumed from a saved stacked state ends byte for byte as
  the uninterrupted one; the stacked state round-trips through the
  checkpoint files with each problem's generator state.
* ``fit_stacked``'s mesh check, ``save_fleet_results`` read back by the
  analysis module (``fit_many`` on the quadrature anchor:
  tests/test_torch_fleet_anchor.py).
* The runner: ``[run] seeds`` and a list of same-grid spectra write the
  files of the sequential path byte for byte; spectra that do not stack
  fall back to it.
* ``finalize``'s information H against the JAX package's, and positive at
  |log L| ~ 1.6e5.
* ``is_rank0`` under a patched ``torch.distributed``.
"""

import hashlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch import runner as trunner
from mcalf_torch.analysis import analyze_chains
from mcalf_torch.cli import main
from mcalf_torch.config import readconfig
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models.batched import stack_problems
from mcalf_torch.models.torch_model import make_stacked_forward
from mcalf_torch.parallel import fit_stacked, fleet_summary, make_mesh, save_fleet_results
from mcalf_torch.sampler import NSConfig, finalize, nested_sample, nsstate_to_numpy
from mcalf_torch.sampler.nested import (
    nested_sample_stacked,
    stack_states,
    unstack_results,
    unstack_states,
)
from mcalf_torch.utils import rank
from mcalf_torch.utils.checkpoint import load_state, save_state

TESTDATA = Path(__file__).parents[1] / "testdata"
_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], specres=[8.0],
    Nrange=[12.0, 14.5], zrange=[2.99, 3.01], brange=[10.0, 40.0],
)


def _model(spec="civ_mock_spec.txt", ncomp=(1, 1)):
    return AbsorptionModel.from_file(str(TESTDATA / spec), ncomp=ncomp, **_CIV)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _digest(res):
    return hashlib.sha256(
        np.ascontiguousarray(res.samples_u.numpy()).tobytes()
        + np.ascontiguousarray(res.logl.numpy()).tobytes()
    ).hexdigest()


# ---- the solo sampler, bit for bit as before the problem axis ---------------

#: logZ (float hex), n_like, outer steps and a digest of samples_u + logl of
#: solo runs at generator seed 5, recorded on the sampler before it had a
#: problem axis
SOLO_REFERENCE = {
    "1comp": ((1, 1), dict(nlive=40, num_repeats=4, max_samples=2000),
              "0x1.379bac0000000p+12", 30220, 39,
              "03662b092432dc2e376703df78e66386165549188defe1df96240c120ba61af1"),
    "transdim": ((1, 2), dict(nlive=40, num_repeats=4, max_samples=600),
                 "0x1.3787a80000000p+12", 13920, 30,
                 "4429f70f44c4e24ebd023934219863ccbb7ea9379d5dc6950bcedddca30f12fd"),
}


@pytest.mark.parametrize("name", sorted(SOLO_REFERENCE))
def test_solo_nested_sample_regression(name):
    ncomp, kw, logz_hex, n_like, n_iter, digest = SOLO_REFERENCE[name]
    m = _model(ncomp=ncomp)
    cfg = NSConfig(ndim=m.ndim, canon_layout=m.canon_layout(), **kw)
    r = nested_sample(make_torch_forward(m, "cpu").loglike_cube, _gen(5), cfg, "cpu")
    assert (float(r.logz).hex(), r.n_like, r.n_iter, _digest(r)) == (
        logz_hex, n_like, n_iter, digest)


# ---- fleet members against solo runs ------------------------------------------

FLEET_CFG = NSConfig(ndim=4, nlive=40, num_repeats=3, max_samples=2000)


@pytest.fixture(scope="module")
def fleet():
    """Three problems (two seeds of one spectrum, and another spectrum)
    run to convergence as one fleet, and each alone."""
    models = [_model(), _model(), _model("civ_mock_spec_multicomp.txt")]
    seeds = [5, 6, 5]
    spec, stacked = stack_problems(models)
    fwd = make_stacked_forward(spec, stacked, "cpu")
    calls = []

    def ll(u, prob):
        calls.append(sorted(set(prob.tolist())))
        return fwd.loglike_cube(u, prob)

    finals = nested_sample_stacked(ll, [_gen(s) for s in seeds], FLEET_CFG, "cpu")
    solo = [
        nested_sample(make_torch_forward(m, "cpu").loglike_cube, _gen(s), FLEET_CFG, "cpu")
        for m, s in zip(models, seeds)
    ]
    return [finalize(f, FLEET_CFG) for f in finals], solo, calls


def test_fleet_members_are_solo_runs_bit_for_bit(fleet):
    members, solo, calls = fleet
    for f, s in zip(members, solo):
        assert float(f.logz).hex() == float(s.logz).hex()
        assert (f.n_like, f.n_iter, f.n_dead) == (s.n_like, s.n_iter, s.n_dead)
        for k in ("samples_u", "logl", "logw", "birth_logl", "insertion_rank"):
            assert torch.equal(getattr(f, k), getattr(s, k)), k
        assert f.termination_reason == s.termination_reason == 0


def test_fleet_members_finish_at_different_steps(fleet):
    members, _, calls = fleet
    steps = [m.n_iter for m in members]
    assert len(set(steps)) == 3, steps
    # every likelihood call served every problem still running, and a
    # finished problem left the stack
    assert calls[0] == [0, 1, 2]
    assert calls[-1] == [int(np.argmax(steps))]
    assert [0, 1, 2] in calls and any(len(c) < 3 for c in calls)


def test_finalize_h_positive_at_large_loglike(fleet):
    # the 1-comp model on civ_mock_spec_multicomp.txt: |log L| ~ 1.6e5,
    # where H = sum p ln L - ln Z cancelled to <= 0 in float32
    members, _, _ = fleet
    r = members[2]
    assert float(r.logz) < -1.5e5
    assert float(r.h) > 1.0 and float(r.logzerr) > 0.0
    assert math.isclose(float(r.logzerr), math.sqrt(float(r.h) / FLEET_CFG.nlive), rel_tol=1e-6)


def test_finalize_matches_jax():
    """The repaired H against mcalf_tpu's on a well-conditioned run (log L
    of order 1): the same final state through both finalize functions."""
    import jax
    import jax.numpy as jnp

    from mcalf_tpu.sampler import nested as jn
    from mcalf_torch.sampler import nsstate_from_numpy

    def jll(u):
        norm = -0.5 * 2 * np.log(2 * np.pi * 0.05**2)
        return (norm - 0.5 * jnp.sum((u - 0.5) ** 2, axis=-1) / 0.05**2).astype(jnp.float32)

    jcfg = jn.NSConfig(ndim=2, nlive=100, max_samples=8000)
    js = jn.run_steps(jll, jn.init_state(jll, jax.random.PRNGKey(0), jcfg), jcfg, 40)
    want = jn.finalize(jll, js, jcfg)
    got = finalize(nsstate_from_numpy(js, "cpu"), NSConfig(ndim=2, nlive=100, max_samples=8000))
    assert float(want.h) > 1.0
    assert math.isclose(float(got.h), float(want.h), rel_tol=1e-4)
    assert math.isclose(float(got.logzerr), float(want.logzerr), rel_tol=1e-4)
    assert float(got.logz) == float(want.logz)


# ---- fit_stacked: chunked resume, checkpoints, mesh ---------------------------

RESUME_CFG = NSConfig(ndim=4, nlive=40, num_repeats=2, max_samples=600)


def test_fit_stacked_resumes_byte_for_byte(tmp_path):
    """A fleet stopped after its second chunk and resumed from the saved
    stacked state (the twin of tests/test_sharding.py's chunked resume)."""
    spec, stacked = stack_problems([_model(), _model("civ_mock_spec_multicomp.txt")])
    mesh = make_mesh(["cpu"])
    run = lambda **kw: fit_stacked(spec, stacked, RESUME_CFG, mesh=mesh, chunk_steps=10,
                                   generators=[_gen(1), _gen(2)], **kw)
    saved = []

    def keep(states):
        saved.append(str(tmp_path / f"fleet_{len(saved)}.npz"))
        save_state(saved[-1], states, fingerprint={"nprob": 2})

    straight = run(on_chunk=keep)
    assert len(saved) == 3  # boundaries at 10, 20, 30 outer steps (the cap)

    class Killed(RuntimeError):
        pass

    chunks = []

    def die_after_two(states):
        chunks.append(states.step)
        if len(chunks) == 2:
            raise Killed

    with pytest.raises(Killed):
        run(on_chunk=die_after_two)
    assert chunks == [(10, 10), (20, 20)]
    loaded = load_state(saved[1], fingerprint={"nprob": 2}, device="cpu")
    assert loaded.step == (20, 20) and loaded.rng.shape[0] == 2
    # the generators go on from the saved states, whatever they stood at
    resumed = fit_stacked(spec, stacked, RESUME_CFG, mesh=mesh, chunk_steps=10,
                          generators=[_gen(99), _gen(98)], states=loaded)
    for a, b in zip(unstack_results(straight), unstack_results(resumed)):
        for k in a._fields:
            x, y = getattr(a, k), getattr(b, k)
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y, k


def test_stacked_state_checkpoint_round_trip(tmp_path):
    m = _model()
    fwd = make_torch_forward(m, "cpu")
    cfg = RESUME_CFG
    states = []
    for seed in (3, 4):
        _, st = nested_sample(fwd.loglike_cube, _gen(seed), NSConfig(
            ndim=4, nlive=40, num_repeats=2, max_samples=200), "cpu", return_state=True)
        states.append(st)
    stacked = stack_states(states)
    assert stacked.n_dead == (states[0].n_dead, states[1].n_dead)
    path = str(tmp_path / "s.npz")
    save_state(path, stacked)
    back = unstack_states(load_state(path, device="cpu"))
    for a, b in zip(states, back):
        x, y = nsstate_to_numpy(a), nsstate_to_numpy(b)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert isinstance(b.n_like, int) and b.rng.dtype == torch.uint8


def test_fit_stacked_checks_the_mesh():
    spec, stacked = stack_problems([_model()] * 3)
    with pytest.raises(ValueError, match=r"number of problems \(3\) must be a multiple of mesh size \(2\)"):
        fit_stacked(spec, stacked, RESUME_CFG, mesh=["cpu", "cpu"])
    # a 2-entry mesh: each block (one host thread each) is the one-device
    # fleet of its problems, with those problems' generators
    models = [_model(), _model("civ_mock_spec_multicomp.txt")] * 2
    spec, stacked = stack_problems(models)
    two = fit_stacked(spec, stacked, RESUME_CFG, mesh=["cpu", "cpu"],
                      generators=[_gen(s) for s in (1, 2, 3, 4)])
    for lo in (0, 2):
        one = fit_stacked(*stack_problems(models[lo:lo + 2]), RESUME_CFG, mesh=["cpu"],
                          generators=[_gen(s) for s in (1, 2, 3, 4)[lo:lo + 2]])
        for a, b in zip(two, one):
            want = b.numpy() if torch.is_tensor(b) else b
            got = a[lo:lo + 2].numpy() if torch.is_tensor(a) else a[lo:lo + 2]
            np.testing.assert_array_equal(got, want)
    assert make_mesh(["cpu"]) == [(0, torch.device("cpu"))]
    with pytest.raises(ValueError, match="3 generators for 2 problems"):
        fit_stacked(*stack_problems([_model()] * 2), RESUME_CFG, mesh=["cpu"],
                    generators=[_gen(0)] * 3)


def test_make_mesh_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_save_fleet_results_reads_back(tmp_path):
    models = [_model(), _model("civ_mock_spec_multicomp.txt")]
    spec, stacked = stack_problems(models)
    res = fit_stacked(spec, stacked, RESUME_CFG, seed=3, mesh=["cpu"])
    bases = [str(tmp_path / f"p{i}") for i in range(2)]
    save_fleet_results(res, stacked, bases)
    summary = fleet_summary(res)
    assert summary.shape == (2, 5)
    for i, base in enumerate(bases):
        lnz, err, lhood, post = analyze_chains(base, return_sorted=False)
        assert abs(lnz - float(res.logz[i])) < 1e-6 * abs(lnz)
        assert abs(err - float(res.logzerr[i])) < 1e-6
        assert post.shape == (int(res.n_dead[i]), 4)
        lo, hi = stacked["lo"][i], stacked["hi"][i]
        assert np.all((post >= lo - 1e-4) & (post <= hi + 1e-4))
        assert summary[i, 0] == float(res.logz[i]) and summary[i, 3] == res.n_like[i]


def test_default_generators_differ_per_problem():
    spec, stacked = stack_problems([_model()] * 2)
    res = fit_stacked(spec, stacked, RESUME_CFG, seed=11, mesh=["cpu"])
    again = fit_stacked(spec, stacked, RESUME_CFG, seed=11, mesh=["cpu"])
    assert float(res.logz[0]) != float(res.logz[1])
    assert torch.equal(res.logz, again.logz)


# ---- the runner ---------------------------------------------------------------

CFG = """
[input]
specfile = {specfile}
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
{run}

[ns_settings]
nlive = 40
num_repeats = 4
max_samples = 400
precision_criterion = 0.01
"""


def _cfg(path, out, specfile="civ_mock_spec.txt", run="", datadir=TESTDATA):
    path.write_text(CFG.format(specfile=specfile, datadir=datadir, out=out, run=run))
    return str(path)


def _same_files(a, b):
    for suffix in (".stats", "_equal_weights.txt"):
        assert Path(a + suffix).read_bytes() == Path(b + suffix).read_bytes(), suffix


def test_runner_seeds_write_the_sequential_files(tmp_path, capsys):
    cp = readconfig(_cfg(tmp_path / "fit.cfg", tmp_path / "fleet", run="seeds = 43,44"))
    rows = []
    orig = trunner.fit_stacked

    def counted(*a, **k):
        rows.append(len(k["generators"]))
        return orig(*a, **k)

    trunner.fit_stacked = counted
    try:
        assert main([str(tmp_path / "fit.cfg"), "--debug"]) == 0
    finally:
        trunner.fit_stacked = orig
    assert rows == [2] and "2 seeds as one fleet on cpu" in capsys.readouterr().out
    # the path before the fleet: one nested_sample per seed, its files
    model = trunner.build_model(cp)
    fwd = make_torch_forward(model, "cpu")
    plan, cfg, _ = trunner._sampler_configs(cp, model, "cpu")
    for s in (43, 44):
        r = nested_sample(fwd.loglike_cube, _gen(s), cfg, "cpu").numpy()
        ref = str(tmp_path / f"ref_s{s}")
        trunner._write_chain_files(ref, fwd, r, plan.resample_S)
        _same_files(str(tmp_path / "fleet" / "fits" / f"fit_0_s{s}"), ref)


def test_runner_spectra_write_the_sequential_files(tmp_path, capsys):
    specs = "civ_mock_spec.txt, civ_mock_spec_multicomp.txt"
    cp = readconfig(_cfg(tmp_path / "fit.cfg", tmp_path / "fleet", specfile=specs))
    out = trunner.run_fit(cp)
    text = capsys.readouterr().out
    assert text.count("(one fleet of 2 spectra on cpu)") == 2
    assert [Path(b).name for _, b in out] == ["fit_0_civ_mock_spec", "fit_0_civ_mock_spec_multicomp"]
    for sub, (res, base) in zip(trunner.spectrum_subconfigs(cp), out):
        alone = dict(sub, chaindir=str(tmp_path / "alone"))
        res1, base1 = trunner.run_fit(alone)
        assert Path(base1).name == Path(base).name
        _same_files(base, base1)
        assert res.n_like == res1.n_like


def test_runner_spectra_that_do_not_stack_fit_sequentially(tmp_path, capsys):
    # every second pixel: twice the velocity step, so another LSF half width
    rows = np.loadtxt(TESTDATA / "civ_mock_spec.txt")[::2]
    np.savetxt(tmp_path / "coarse.txt", rows, header="Wave Flux Err")
    (tmp_path / "civ_mock_spec.txt").write_bytes((TESTDATA / "civ_mock_spec.txt").read_bytes())
    cfg = _cfg(tmp_path / "fit.cfg", tmp_path, specfile="civ_mock_spec.txt, coarse.txt",
               datadir=tmp_path)
    out = trunner.run_fit(readconfig(cfg))
    text = capsys.readouterr().out
    assert "NOTE: spectra do not stack for one fleet (problem 1 has incompatible structure" in text
    assert "fitting sequentially" in text and text.count("--- fitting ") == 2
    assert len(out) == 2


def test_runner_spectra_with_checkpoints_fit_sequentially(tmp_path, capsys):
    specs = "civ_mock_spec.txt, civ_mock_spec_multicomp.txt"
    cp = readconfig(_cfg(tmp_path / "fit.cfg", tmp_path, specfile=specs,
                         run=f"checkpoint = {tmp_path / 'ck'}"))
    trunner.run_fit(cp)
    assert "one fleet" not in capsys.readouterr().out
    for stem in ("civ_mock_spec", "civ_mock_spec_multicomp"):
        assert list((tmp_path / "ck" / stem).glob("ns_state_*.npz"))


# ---- rank gating ---------------------------------------------------------------

def test_is_rank0(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("RANK", raising=False)
    assert rank.is_rank0()
    monkeypatch.setenv("RANK", "2")
    assert not rank.is_rank0()
    monkeypatch.setenv("RANK", "0")
    assert rank.is_rank0()
    # an initialised process group decides over the environment
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert not rank.is_rank0()
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setenv("RANK", "3")
    assert rank.is_rank0()


def test_rank0_print_and_the_cli(monkeypatch, capsys, tmp_path):
    import sys

    monkeypatch.setenv("RANK", "1")
    rank.rank0_print("hidden")
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("RANK", "0")
    rank.rank0_print("shown")
    assert capsys.readouterr().out == "shown\n"
    # a rank other than 0 runs the fit without printing
    cfg = _cfg(tmp_path / "fit.cfg", tmp_path)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # restored after the test
    assert main([cfg]) == 0
    assert (tmp_path / "fits" / "fit_0.stats").exists()
