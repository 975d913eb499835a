"""Dynamic (posterior-boost) nested sampling in the port: the host pieces
against ``mcalf_tpu.sampler.dynamic`` (exact), ``solver_nsconfig`` field by
field with the boost settings, resume from a terminal base state bit for
bit, and the Gaussian twins of tests/test_dynamic.py at the same sizes and
bars."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcalf_tpu import runner as jrunner
from mcalf_tpu.sampler import dynamic as jdyn
from mcalf_torch import runner as trunner
from mcalf_torch.sampler import NSConfig, dynamic_sample, posterior_ess, resample_equal
from mcalf_torch.sampler import dynamic as tdyn
from mcalf_torch.utils.checkpoint import load_state, save_state


def gaussian_loglike(sigma, ndim, mu=0.5):
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def loglike(u):
        r2 = torch.sum((u - mu) ** 2, dim=-1)
        return (norm - 0.5 * r2 / sigma**2).to(torch.float32)

    return loglike


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- exact, against the JAX package -----------------------------------------

def _weighted_run(seed, n=400):
    rng = np.random.default_rng(seed)
    logl = rng.normal(-30.0, 6.0, n).astype(np.float32)
    logp = (logl + rng.normal(0.0, 1.0, n)).astype(np.float32)
    logp[rng.integers(0, n, 25)] = -np.inf  # unfilled rows
    logp -= np.float32(np.log(np.exp(logp[np.isfinite(logp)].astype(np.float64)).sum()))
    return SimpleNamespace(log_posterior_weights=logp, logl=logl)


@pytest.mark.parametrize("mass", [0.0, 0.01, 0.3, 0.999, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_choose_l_init_matches_jax(seed, mass):
    base = _weighted_run(seed)
    assert tdyn._choose_l_init(base, mass) == jdyn._choose_l_init(base, mass)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_posterior_ess_matches_jax(seed):
    logp = _weighted_run(seed).log_posterior_weights
    assert posterior_ess(logp) == jdyn.posterior_ess(logp)
    assert posterior_ess(np.full(5, -np.inf)) == jdyn.posterior_ess(np.full(5, -np.inf)) == 0.0


SOLVER_CASES = {
    # the cases of tests/test_dynamic.py::test_dypolychord_solver_maps_to_dynamic
    "dypolychord": {"solver": "dypolychord"},
    "polychord": {"solver": "polychord"},
    "polychord-dynamic": {"solver": "polychord", "ns_settings": {"dynamic": "True"}},
    "dypolychord-static": {"solver": "dypolychord", "ns_settings": {"dynamic": "false"}},
    "dynesty": {"solver": "dynesty"},
    "dynesty-static": {"solver": "dynesty", "ns_settings": {"dynamic": "false"}},
    # the boost settings and the PolyChord keys
    "boost": {"solver": "dypolychord", "pc_settings": {"nlive": "70", "dynamic_goal": "0.5"},
              "ns_settings": {"boost_nlive": "30", "boost_num_repeats": "9",
                              "boost_max_samples": "1e3", "max_samples": "5000"}},
    "boost-mass": {"solver": "polychord", "pc_settings": {"write_dead": "False"},
                   "ns_settings": {"dynamic": "yes", "boost_start_mass": "0.2",
                                   "boost_nlive": "44"}},
    "bare-pc": {"solver": "polychord", "pc_settings": {"nlive": "55"}},
    "pc-no-resume": {"solver": "polychord",
                     "pc_settings": {"read_resume": "False", "do_clustering": "false"}},
    "multinest": {"solver": "multinest", "mn_settings": {"nlive": "300"}},
    "jaxns": {"solver": "jaxns", "jaxns_settings": {"max_samples": "700",
                                                     "difficult_model": "true"}},
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solver_nsconfig_matches_jax(case):
    cp = SOLVER_CASES[case]
    want, got = jrunner.solver_nsconfig(cp, ndim=4), trunner.solver_nsconfig(cp, ndim=4)
    assert got._fields == want._fields
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if f in ("cfg", "boost_config"):
            assert (w is None) == (g is None), f
            if w is not None:
                assert dataclasses.asdict(g) == dataclasses.asdict(w), f
        else:
            assert g == w and type(g) is type(w), f
    assert got.dynamic == ("dynamic" in case or case in ("dypolychord", "dynesty", "boost", "boost-mass"))
    if case == "boost":
        assert got.boost_config.nlive == 30 and got.boost_start_mass == 0.005
        assert got.boost_config.max_samples == 1000 and got.cfg.max_samples == 5000


# ---- the port against itself --------------------------------------------------

def test_dynamic_resume_bit_identical(tmp_path):
    """A dynamic run killed mid-flight and resumed from its checkpoints must
    reach the same merged evidence as the uninterrupted run, bit for bit."""
    ndim, sigma = 3, 0.08
    ll = gaussian_loglike(sigma, ndim)
    cfg = NSConfig(ndim=ndim, nlive=60, max_samples=6000)

    saved = {"base": [], "boost": []}
    straight = dynamic_sample(
        ll, _gen(5), cfg, "cpu",
        on_chunk_base=saved["base"].append,
        on_chunk_boost=saved["boost"].append,
    )
    # The last callback state of each pass is its terminal state.  Resume
    # from the TERMINAL base alone: the base pass is replayed as a no-op
    # finalization, the generator goes back to where the base pass left it,
    # and seeding and boost follow as before.
    bpath = str(tmp_path / "ns_state_final.npz")
    save_state(bpath, saved["base"][-1])
    from_base = dynamic_sample(ll, _gen(77), cfg, "cpu", base_state=load_state(bpath, device="cpu"))
    assert from_base.l_init == straight.l_init
    assert from_base.merged.logz == straight.merged.logz
    np.testing.assert_array_equal(from_base.boost.samples_u, straight.boost.samples_u)

    # ...and from the terminal base + a round-tripped mid-boost checkpoint.
    assert len(saved["boost"]) >= 2
    opath = str(tmp_path / "ns_boost_mid.npz")
    save_state(opath, saved["boost"][0])
    resumed = dynamic_sample(
        ll, _gen(78), cfg, "cpu",
        base_state=load_state(bpath, device="cpu"),
        boost_state=load_state(opath, device="cpu"),
    )
    assert resumed.merged.logz == straight.merged.logz
    assert resumed.l_init == straight.l_init
    np.testing.assert_array_equal(resumed.merged.samples_u, straight.merged.samples_u)


def test_seed_boost_state_draws_from_the_runs_generator():
    ll = gaussian_loglike(0.08, 3)
    cfg = NSConfig(ndim=3, nlive=40, num_repeats=6, max_samples=3000)
    from mcalf_torch.sampler import nested_sample

    base = nested_sample(ll, _gen(1), cfg, "cpu").numpy()
    l_init = tdyn._choose_l_init(base, 0.01)
    states = [
        tdyn._seed_boost_state(ll, _gen(s), base, l_init, cfg.resolved(), "cpu")
        for s in (9, 9, 10)
    ]
    assert torch.equal(states[0].live_u, states[1].live_u)
    assert not torch.equal(states[0].live_u, states[2].live_u)
    s = states[0]
    assert bool((s.live_logl > l_init).all()) and bool((s.live_birth == np.float32(l_init)).all())
    assert s.n_dead == 0 and s.step == 0 and s.n_like > cfg.nlive and s.rng is None
    with pytest.raises(ValueError, match="lower boost_start_mass"):
        tdyn._seed_boost_state(ll, _gen(0), base, float(base.logl.max()), cfg.resolved(), "cpu")


# ---- statistical (tolerances of tests/test_dynamic.py) -------------------------

def test_dynamic_gaussian():
    ndim, sigma = 4, 0.08
    ll = gaussian_loglike(sigma, ndim)
    cfg = NSConfig(ndim=ndim, nlive=100, max_samples=10000)
    dyn = dynamic_sample(ll, _gen(0), cfg, "cpu")

    # evidence: merged estimate agrees with the analytic truth (logZ = 0)
    # within 4 merged errors (or 0.15)
    assert abs(dyn.merged.logz) < max(4 * dyn.merged.logzerr, 0.15), (
        dyn.merged.logz, dyn.merged.logzerr,
    )
    # the boost threshold sits below the posterior bulk
    assert dyn.l_init < float(np.nanmax(dyn.base.logl))

    # posterior ESS: the boost raises the effective sample count by over
    # 1.5x at the same nlive (its whole run lives inside the posterior bulk)
    ess_base = posterior_ess(dyn.base.log_posterior_weights)
    ess_merged = posterior_ess(dyn.merged.log_posterior_weights)
    assert ess_merged > 1.5 * ess_base, (ess_base, ess_merged)

    # posterior moments preserved by the merge (mean to 0.015, sd to 0.02)
    s, _ = resample_equal(_gen(1), dyn.merged, 4000)
    assert np.all(np.abs(s.mean(axis=0) - 0.5) < 0.015), s.mean(axis=0)
    assert np.all(np.abs(s.std(axis=0) - sigma) < 0.02), s.std(axis=0)


def test_merged_logzerr_calibrated_against_repeat_scatter():
    """MergedRun.logzerr (simulated-weights estimate) must be consistent
    with the actual scatter of repeated dynamic runs."""
    ndim, sigma = 3, 0.08
    ll = gaussian_loglike(sigma, ndim)
    cfg = NSConfig(ndim=ndim, nlive=80, max_samples=6000)
    runs = [dynamic_sample(ll, _gen(100 + i), cfg, "cpu") for i in range(4)]
    logzs = np.array([r.merged.logz for r in runs])
    errs = np.array([r.merged.logzerr for r in runs])
    # all runs agree with the analytic truth (logZ = 0) within 4 error bars
    assert np.all(np.abs(logzs) < 4 * errs + 0.05), (logzs, errs)
    # the quoted error is the right ORDER: neither 5x smaller than the
    # empirical scatter (overconfident) nor 10x larger (useless)
    scatter = logzs.std(ddof=1)
    assert errs.mean() > scatter / 5, (scatter, errs)
    assert errs.mean() < 10 * scatter + 0.2, (scatter, errs)
