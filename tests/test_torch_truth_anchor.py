"""tools/torch_truth_anchor.py, the port's quadrature evidence of the 1-comp
CIV fit, against the JAX package's (tools/truth_anchor.py).

* ``ll_grid`` through the port's likelihood on a 5 x 41 x 5 grid against
  ``make_jax_forward(model).loglike_cube`` on the same rows, Harris
  (``brange = 10, 40``) and damped (``3, 40``): rtol 1e-5 / atol 0.05 (the
  JAX package's fused-vs-XLA bar).
* The quadrature and moment formulas against the JAX script's on synthetic
  arrays (float64 on the host: equal to 1e-12).
* The whole study on a reduced grid through both packages' likelihoods:
  logZ within 0.05, the moments close.
* The JAX package's values of the full quadrature, taken on the CPU and
  stored here (and in chip_smoke.py, whose phase 15 holds the port's run on
  the card against them), beside the JAX package's own anchors.

To recompute the stored values (about 3 and 10 minutes on 8 cores):

    JAX_PLATFORMS=cpu python tests/test_torch_truth_anchor.py 10,40
    JAX_PLATFORMS=cpu python tests/test_torch_truth_anchor.py 3,40
"""

import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).parents[1]
sys.path.insert(0, str(REPO / "tools"))

import torch_truth_anchor as ta  # noqa: E402

from mcalf_torch.models import make_torch_forward  # noqa: E402

#: the JAX package's full quadrature of testdata/civ_mock_spec.txt on the
#: CPU (jax 0.9.0, XLA likelihood), by this file's ``__main__`` (the command
#: in the docstring): logZ, peak log L and the (N, z, b) posterior mean and sd
JAX_QUADRATURE = {
    (10.0, 40.0): dict(
        logz=4985.520790475888, peak=5005.171875,
        moments={"N": (13.799970399693077, 0.00302712920670298),
                 "z": (3.00000048025581, 9.473122215751973e-07),
                 "b": (14.918670666438624, 0.09293213593021848)}),
    (3.0, 40.0): dict(
        logz=4985.311086999623, peak=5005.1748046875,
        moments={"N": (13.799970399726494, 0.0030271159062394597),
                 "z": (3.0000004802461393, 9.473072055341726e-07),
                 "b": (14.918672196773457, 0.09293110943311958)}),
}
#: the JAX package's anchor of the repo's mock (tools/truth_anchor.py on a
#: TPU, tests/test_truth_anchor.py's note), and the narrow anchor derived
#: from it before any quadrature of the narrow prior existed
JAX_TPU_ANCHOR = 4985.51
DERIVED_NARROW = JAX_TPU_ANCHOR + math.log(30.0 / 37.0)

BRANGES = ((10.0, 40.0), (3.0, 40.0))


def _jax_loglike(brange):
    import jax
    import jax.numpy as jnp

    from mcalf_tpu.models import AbsorptionModel, make_jax_forward

    model = AbsorptionModel.from_file(
        str(REPO / "testdata" / "civ_mock_spec.txt"),
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1), specres=[8.0],
        Nrange=[12.0, 14.5], brange=list(brange), zrange=[2.99, 3.01],
    )
    f = jax.jit(make_jax_forward(model).loglike_cube)
    return lambda u: np.asarray(f(jnp.asarray(u)), np.float64), model


def _port_loglike(brange):
    model = ta.make_model(brange=brange)
    return ta.torch_loglike(make_torch_forward(model, "cpu")), model


@pytest.mark.parametrize("brange", BRANGES)
def test_ll_grid_matches_jax(brange):
    grid = (np.linspace(0, 1, 5), np.linspace(0.45, 0.55, 41), np.linspace(0, 1, 5))
    port, _ = _port_loglike(brange)
    jax_ll, _ = _jax_loglike(brange)
    got = ta.ll_grid(port, *grid, batch=64)
    want = jax_ll(ta.grid_rows(*grid)).reshape(got.shape)
    assert got.shape == (5, 41, 5) and got.dtype == np.float64
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.05)


def _jax_script_formulas(llf, uNf, uzf, ubf, lo, hi):
    """tools/truth_anchor.py's quadrature and moments, verbatim."""
    m = llf.max(); w = np.exp(llf - m)  # noqa: E702

    def tw(x):
        g = np.gradient(x); g[0] = (x[1] - x[0]) / 2; g[-1] = (x[-1] - x[-2]) / 2  # noqa: E702
        return g
    I = np.einsum("i,j,k,ijk->", tw(uNf), tw(uzf), tw(ubf), w)  # noqa: E741
    edge = max(w[0].max(), w[-1].max(), w[:, 0, :].max(), w[:, -1, :].max(),
               w[:, :, 0].max(), w[:, :, -1].max())
    wN = tw(uNf); wz = tw(uzf); wb = tw(ubf)  # noqa: E702
    W = np.einsum("i,j,k,ijk->ijk", wN, wz, wb, w)
    W /= W.sum()
    mom = {}
    for name, axis, grid, d in (("N", 0, uNf, 1), ("z", 1, uzf, 2), ("b", 2, ubf, 3)):
        marg = W.sum(axis=tuple(a for a in range(3) if a != axis))
        mu_u = float((grid * marg).sum())
        sd_u = float(np.sqrt(((grid - mu_u) ** 2 * marg).sum()))
        mom[name] = (lo[d] + mu_u * (hi[d] - lo[d]), sd_u * (hi[d] - lo[d]))
    return m + np.log(I), m, edge, mom


def test_quadrature_and_moments_match_the_jax_formulas():
    rng = np.random.default_rng(5)
    grids = tuple(np.sort(rng.uniform(0, 1, n)) for n in (7, 9, 11))
    X = np.meshgrid(*grids, indexing="ij")
    llf = 4000.0 - sum((x - c) ** 2 / (2 * s**2) for x, c, s in zip(X, (0.4, 0.6, 0.5), (0.1, 0.2, 0.15)))
    lo, hi = np.array([0.0, 12.0, 2.99, 10.0]), np.array([1.0, 14.5, 3.01, 40.0])
    want = _jax_script_formulas(llf, *grids, lo, hi)
    logz, peak, edge = ta.quadrature_logz(llf, grids)
    assert math.isclose(logz, want[0], rel_tol=1e-12) and peak == want[1]
    assert math.isclose(edge, want[2], rel_tol=1e-12) and edge > 0
    mom = ta.moments(llf, grids, lo, hi)
    for k in "Nzb":
        np.testing.assert_allclose(mom[k], want[3][k], rtol=1e-12)
    # the trapezoid weights integrate a linear function exactly
    x = grids[1]
    assert math.isclose(float(ta.trapezoid_weights(x) @ (2 * x + 1)),
                        (x[-1] ** 2 + x[-1]) - (x[0] ** 2 + x[0]), rel_tol=1e-12)


@pytest.mark.parametrize("brange", BRANGES)
def test_study_on_a_small_grid_matches_jax(brange, monkeypatch):
    """The whole study (coarse peak, fine grid around it, logZ, moments)
    through both likelihoods, on grids cut to 5 x 201 x 5 and 9 x 17 x 9
    (the fine one narrowed in z to about 3 posterior sd): the same peak
    row, logZ within 0.05, the means to 1e-9 and the sds to 1e-3
    relative (log L differs by up to about 1e-3 near the peak)."""
    monkeypatch.setattr(ta, "COARSE", (5, 201, 5))
    monkeypatch.setattr(ta, "FINE", (9, 17, 9))
    monkeypatch.setattr(ta, "FINE_HALF", (0.006, 1.5e-4, 0.01))
    port, model = _port_loglike(brange)
    jax_ll, _ = _jax_loglike(brange)
    got = ta.anchor(port, model.bounds_lo, model.bounds_hi, batch=512, log=lambda *a: None)
    want = ta.anchor(jax_ll, model.bounds_lo, model.bounds_hi, batch=512, log=lambda *a: None)
    assert got["rows"] == 5 * 201 * 5 + 9 * 17 * 9
    assert got["peak_u"] == want["peak_u"]
    assert abs(got["logz"] - want["logz"]) < 0.05, (got["logz"], want["logz"])
    for k in "Nzb":
        (mu, sd), (mu_j, sd_j) = got["moments"][k], want["moments"][k]
        assert math.isclose(mu, mu_j, rel_tol=1e-9) and math.isclose(sd, sd_j, rel_tol=1e-3), k


def test_stored_references_agree_with_the_jax_package_anchors():
    """The stored CPU quadratures against the JAX package's TPU anchor
    (Harris) and the narrow anchor derived from it, to 0.05; the two priors
    share the posterior (it lies where b > 10 km/s), so their moments agree
    to 1e-4 relative."""
    harris, narrow = JAX_QUADRATURE[10.0, 40.0], JAX_QUADRATURE[3.0, 40.0]
    assert abs(harris["logz"] - JAX_TPU_ANCHOR) < 0.05
    assert abs(narrow["logz"] - DERIVED_NARROW) < 0.05
    for k in "Nzb":
        np.testing.assert_allclose(narrow["moments"][k], harris["moments"][k], rtol=1e-4)


def test_chip_smoke_holds_the_same_values():
    """chip_smoke.py phase 15 (c) gates the card's quadratures on these."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.JAX_QUADRATURE) == set(JAX_QUADRATURE)
    for k, want in JAX_QUADRATURE.items():
        got = smoke.JAX_QUADRATURE[k]
        assert got["logz"] == want["logz"] and got["moments"] == want["moments"]
    assert smoke.QUADRATURE_BAR == 0.05


if __name__ == "__main__":
    import json

    lo_hi = tuple(float(x) for x in (sys.argv[1] if len(sys.argv) > 1 else "10,40").split(","))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax_ll, model = _jax_loglike(lo_hi)
    res = ta.anchor(jax_ll, model.bounds_lo, model.bounds_hi)
    import jax

    print(json.dumps(dict(res, brange=list(lo_hi), jax=jax.__version__)))
