"""mcalf_torch's strong-damping special functions (erfcx, Algorithm 916, the
asymptotic form, hjert) against mcalf_tpu's and against scipy.

Grids: those of tests/test_faddeeva.py (the reference domain, the wide
domain, both sides of the r^2 = 111 switch, evenness in u).

Tolerances: port against JAX, 1e-5 relative (the two packages evaluate
the same float32 formulas; exp, sin, cos and fused multiply-add
contraction differ between XLA and PyTorch by an ulp or two, and the
series sums some tens of such terms).  Port against scipy.special.wofz,
the JAX package's own bars: 1e-6 on the reference domain, 3e-5 on the wide
one, 1e-4 at the region switch; erfcx 5e-7 for x >= 0 and 2e-5 below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch

from mcalf_tpu.ops import faddeeva as jfad
from mcalf_torch.ops import faddeeva as tfad

PORT_VS_JAX = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want) / np.abs(want))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


# the test_faddeeva.py grids
X_ERFCX = np.concatenate(
    [np.linspace(0.0, 30.0, 1001), np.geomspace(1e-6, 1.0, 101)]
).astype(np.float32)
X_ERFCX_NEG = np.linspace(-9.0, -0.01, 301).astype(np.float32)


def _grid(a_hi, n_a, u_hi, n_u):
    a = np.geomspace(1e-4, a_hi, n_a)
    u = np.concatenate([[0.0], np.geomspace(1e-3, u_hi, n_u)])
    U, A = np.meshgrid(u, a)
    return U.astype(np.float32), A.astype(np.float32)


GRIDS = {
    "reference": (_grid(1.0, 60, 100.0, 240), 1e-6),
    "wide": (_grid(50.0, 80, 3000.0, 300), 3e-5),
}


def test_constants_match_jax():
    assert tfad.ERFCX_COEF == tuple(float(v) for v in jfad._ERFCX_COEF)
    assert tfad.N_TERMS == jfad._N_TERMS
    assert tfad.AN == tuple(float(v) for v in jfad._AN)
    assert tfad.AN2 == tuple(float(v) for v in jfad._AN2)
    assert tfad.EXP_AN2 == tuple(float(v) for v in jfad._EXP_AN2)
    assert tfad.UP_RATIO == tuple(
        float(np.exp(-(2 * n + 3) / 4.0)) for n in range(jfad._N_TERMS)
    )


@pytest.mark.parametrize("x,bar", ((X_ERFCX, 5e-7), (X_ERFCX_NEG, 2e-5)))
def test_erfcx_matches_jax_and_scipy(x, bar):
    got = tfad.erfcx(_t(x)).numpy()
    assert _rel(got, np.asarray(jfad.erfcx(jnp.asarray(x)))) <= PORT_VS_JAX
    assert _rel(got, sps.erfcx(x.astype(np.float64))) < bar


@pytest.mark.parametrize("domain", sorted(GRIDS))
def test_hjert_matches_jax_and_scipy(domain):
    (U, A), bar = GRIDS[domain]
    got = tfad.hjert(_t(U), _t(A)).numpy()
    want = np.asarray(jfad.hjert(jnp.asarray(U), jnp.asarray(A)))
    assert _rel(got, want) <= PORT_VS_JAX
    ref = sps.wofz(U.astype(np.float64) + 1j * A.astype(np.float64)).real
    assert _rel(got, ref) < bar


@pytest.mark.parametrize("domain", sorted(GRIDS))
def test_series_and_asymptotic_match_jax(domain):
    """Each branch on its own side of the switch, as hjert calls it."""
    (U, A), _ = GRIDS[domain]
    near = U * U + A * A < tfad.R2_SWITCH
    un, an = U[near], A[near]
    got = tfad.wofz_real_916(_t(un), _t(an)).numpy()
    want = np.asarray(jfad.wofz_real_916(jnp.asarray(un), jnp.asarray(an)))
    assert _rel(got, want) <= PORT_VS_JAX
    uf, af = U[~near], A[~near]
    got = tfad.wofz_real_asym(_t(uf), _t(af)).numpy()
    want = np.asarray(jfad.wofz_real_asym(jnp.asarray(uf), jnp.asarray(af)))
    assert _rel(got, want) <= PORT_VS_JAX


@pytest.mark.parametrize("eps", (-1e-3, 0.0, 1e-3))
def test_hjert_both_sides_of_the_switch(eps):
    r = np.sqrt(111.0)
    theta = np.linspace(1e-3, np.pi / 2 - 1e-3, 101)
    u = ((r + eps) * np.cos(theta)).astype(np.float32)
    a = ((r + eps) * np.sin(theta)).astype(np.float32)
    got = tfad.hjert(_t(u), _t(a)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, np.asarray(jfad.hjert(jnp.asarray(u), jnp.asarray(a)))) <= PORT_VS_JAX
    want = sps.wofz(u.astype(np.float64) + 1j * a.astype(np.float64)).real
    assert _rel(got, want) < 1e-4


def test_hjert_even_in_u():
    u = torch.linspace(0.0, 50.0, 501)
    a = torch.tensor(0.01)
    assert torch.equal(tfad.hjert(u, a), tfad.hjert(-u, a))


def test_hjert_broadcast_column_matches_jax():
    """a as a per-sample column against a pixel axis (the tau layout), with
    the damping of strongly damped lines; u = 0 exercises sinc(0) = 1."""
    u = np.linspace(-40.0, 40.0, 2001, dtype=np.float32)[None, :].repeat(4, axis=0)
    a = np.array([[1e-3], [3e-3], [1e-2], [0.3]], np.float32)
    got = tfad.hjert(_t(u), _t(a)).numpy()
    assert got.shape == (4, 2001) and np.isfinite(got).all()
    assert _rel(got, np.asarray(jfad.hjert(jnp.asarray(u), jnp.asarray(a)))) <= PORT_VS_JAX
