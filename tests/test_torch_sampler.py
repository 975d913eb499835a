"""mcalf_torch's nested sampler against mcalf_tpu's.

Deterministic pieces -- gauge fixing, the deletion bookkeeping of one
outer step, finalization -- are compared on states carried across from
the JAX package (``nsstate_from_numpy``).  The random slice moves cannot
match (torch.Generator is not jax.random), so the sampler as a whole is
held to the analytic Gaussian evidence, as tests/test_sampler.py holds the
JAX one.  Bookkeeping tolerances: float32 roundoff of sums taken in
another order (rtol 1e-6, atol 1e-5 on log quantities).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcalf_tpu.sampler import clusters as jclusters
from mcalf_tpu.sampler import diagnostics as jdiag
from mcalf_tpu.sampler import nested as jn
from mcalf_torch.sampler import clusters as tclusters
from mcalf_torch.sampler import diagnostics as tdiag
from mcalf_torch.sampler import nested as tn
from mcalf_torch.sampler.results import resample_equal

SIGMA, NDIM = 0.05, 2
NORM = -0.5 * NDIM * math.log(2 * math.pi * SIGMA**2)


def jax_gauss(u):
    r2 = jnp.sum((u - 0.5) ** 2, axis=-1)
    return (NORM - 0.5 * r2 / SIGMA**2).astype(jnp.float32)


def torch_gauss(u):
    r2 = torch.sum((u - 0.5) ** 2, dim=-1)
    return (NORM - 0.5 * r2 / SIGMA**2).to(torch.float32)


def _configs(**kw):
    base = dict(ndim=NDIM, nlive=60, max_samples=1200)
    base.update(kw)
    return jn.NSConfig(**base), tn.NSConfig(**base)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX sampler state a few outer steps in (dead buffers part-filled)."""
    jcfg, _ = _configs()
    s = jn.init_state(jax_gauss, jax.random.PRNGKey(3), jcfg)
    s = jn.run_steps(jax_gauss, s, jcfg, 4)
    return s


def test_nsconfig_resolved_matches_jax():
    for kw in (dict(), dict(num_delete=7, num_repeats=5), dict(difficult_model=True),
               dict(nlive=10, num_delete=40)):
        j, t = _configs(**kw)
        assert dataclasses.asdict(j.resolved()) == dataclasses.asdict(t.resolved())


@pytest.mark.parametrize("layout,ncomp", [((0, 4, 2), (1.0, 4.0)), ((1, 3, 0), (0.0, 3.0))])
def test_canonicalize_u_matches_jax(layout, ncomp):
    startind, ncompmax, nfill = layout
    ndim = startind + 1 + 3 * (ncompmax + nfill)
    u = np.random.default_rng(5).uniform(size=(50, ndim)).astype(np.float32)
    vals = ncomp[0] + u[:, startind] * (ncomp[1] - ncomp[0])
    want = np.asarray(jn.canonicalize_u(jnp.asarray(u), layout, jnp.asarray(vals)))
    got = tn.canonicalize_u(torch.from_numpy(u), layout, torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    # and through the live-set wrapper with the 5-entry layout
    jcfg, tcfg = _configs(ndim=ndim, canon_layout=layout + ncomp)
    np.testing.assert_array_equal(
        tn._canon_live(torch.from_numpy(u), tcfg).numpy(),
        np.asarray(jn._canon_live(jnp.asarray(u), jcfg)),
    )


def test_nsstate_roundtrip(jax_state):
    ts = tn.nsstate_from_numpy(jax_state, "cpu")
    back = tn.nsstate_to_numpy(ts)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jax_state, k)), err_msg=k)
    jcfg, tcfg = _configs()
    assert tn.is_done(ts, tcfg) == jn.is_done(jax_state, jcfg)


def test_finalize_matches_jax(jax_state):
    jcfg, tcfg = _configs()
    want = jn.finalize(jax_gauss, jax_state, jcfg)
    got = tn.finalize(tn.nsstate_from_numpy(jax_state, "cpu"), tcfg).numpy()
    for k in ("logz", "logzerr", "h"):
        np.testing.assert_allclose(getattr(got, k), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    for k in ("logw", "log_posterior_weights"):
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6, atol=1e-5, err_msg=k)
    for k in ("samples_u", "logl", "birth_logl", "insertion_rank"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)))
    for k in ("n_dead", "n_like", "n_iter", "termination_reason"):
        assert getattr(got, k) == int(getattr(want, k)), k


def test_one_step_bookkeeping_matches_jax(jax_state):
    """Deletion, volume shrinkage and evidence of one outer step depend only
    on the live set the step starts from, not on the random slice moves."""
    jcfg, tcfg = _configs()
    want = jn.run_steps(jax_gauss, jax_state, jcfg, 1)
    got = tn.run_steps(
        torch_gauss, tn.nsstate_from_numpy(jax_state, "cpu"), tcfg, 1,
        torch.Generator().manual_seed(0),
    )
    got = tn.nsstate_to_numpy(got)
    for k in ("dead_u", "dead_birth"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
    for k in ("dead_logl", "dead_logw", "logx", "logz"):
        a, b = got[k], np.asarray(getattr(want, k))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6, atol=1e-5, err_msg=k)
    assert int(got["n_dead"]) == int(want.n_dead)
    assert int(got["step"]) == int(want.step)
    # every replacement satisfies the hard constraint L > L*
    lstar = got["dead_logl"][int(got["n_dead"]) - 1]
    nd = int(jax_state.n_dead)
    assert np.all(got["live_logl"] >= got["dead_logl"][nd])
    assert np.sum(got["live_birth"] == lstar) == jcfg.resolved().num_delete


@pytest.fixture(scope="module")
def gaussian_run():
    cfg = tn.NSConfig(ndim=NDIM, nlive=100, max_samples=20000)
    res = tn.nested_sample(
        torch_gauss, torch.Generator().manual_seed(0), cfg, "cpu"
    ).numpy()
    return res, cfg


def test_gaussian_evidence(gaussian_run):
    # Z = 1 (logZ = 0) up to negligible truncation, as tests/test_sampler.py
    res, cfg = gaussian_run
    assert res.termination_reason == 0, "did not converge"
    assert res.logzerr < 0.5
    assert abs(res.logz) < max(3.5 * res.logzerr, 0.1), (res.logz, res.logzerr)
    assert tdiag.insertion_rank_test(res, cfg).p_value > 1e-3


def test_evidence_matches_jax_sampler():
    """The whole sampler, both packages, same problem and configuration:
    the evidences agree within 3 combined quoted errors."""
    jcfg, tcfg = _configs()
    j = jn.nested_sample(jax_gauss, jax.random.PRNGKey(11), jcfg)
    t = tn.nested_sample(torch_gauss, torch.Generator().manual_seed(11), tcfg, "cpu")
    jz, je = float(j.logz), float(j.logzerr)
    tz, te = float(t.logz), float(t.logzerr)
    assert int(j.termination_reason) == 0 and t.termination_reason == 0
    assert abs(jz - tz) < 3.0 * math.hypot(je, te), (jz, je, tz, te)
    assert abs(tz) < max(3.5 * te, 0.1)


def test_resample_equal_moments(gaussian_run):
    res, _ = gaussian_run
    su, logl = resample_equal(torch.Generator().manual_seed(42), res, 4000)
    assert su.shape == (4000, NDIM) and logl.shape == (4000,)
    assert np.all(np.abs(su.mean(axis=0) - 0.5) < 0.01), su.mean(axis=0)
    assert np.all(np.abs(su.std(axis=0) - SIGMA) < 0.015), su.std(axis=0)
    # same seed, same draws
    su2, _ = resample_equal(torch.Generator().manual_seed(42), res, 4000)
    np.testing.assert_array_equal(su, su2)


def test_chunking_is_deterministic():
    """Same generator seed and chunk schedule -> identical run."""
    cfg = tn.NSConfig(ndim=NDIM, nlive=40, max_samples=800, num_repeats=4)
    runs = [
        tn.nested_sample(torch_gauss, torch.Generator().manual_seed(9), cfg, "cpu",
                         chunk_steps=3).numpy()
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0].samples_u, runs[1].samples_u)
    assert runs[0].logz == runs[1].logz and runs[0].n_like == runs[1].n_like


def test_cluster_copy_matches_jax():
    rng = np.random.default_rng(2)
    u = np.concatenate([
        rng.normal(0.2, 0.02, size=(60, 3)), rng.normal(0.7, 0.02, size=(40, 3)),
    ])
    lj, kj = jclusters.assign_clusters(u)
    lt, kt = tclusters.assign_clusters(u)
    assert kj == kt == 2
    np.testing.assert_array_equal(lj, lt)


def test_diagnostics_copy_matches_jax():
    class R:
        insertion_rank = np.random.default_rng(4).integers(0, 51, size=2000)

    for kw in (dict(nsurv=50, num_delete=50), dict(nsurv=50, num_delete=1)):
        a = jdiag.insertion_rank_test(R, **kw)
        b = tdiag.insertion_rank_test(R, **kw)
        assert (a.ks_stat, a.p_value, a.p_value_blocks, a.n, a.kappa) == (
            b.ks_stat, b.p_value, b.p_value_blocks, b.n, b.kappa
        )
