"""The wing-window switch: ``MCALF_TORCH_WINDOW=0`` in the port against
``MCALF_TPU_WINDOW=0`` in the JAX package, each set through monkeypatch.

With the switch off every Harris transition takes the plain Harris
expansion on every pixel: ``win_tmin`` is all 0, the mode table all
``MODE_HARRIS``, and the kernels run the counterpart of the plain-Harris
branch of the JAX package's ``_ll_kernel`` and ``_tau_kernel``
(``_accum_tau``, ``mcalf_tpu/ops/voigt_pallas.py:108-109``).  The twins of
tests/test_windowing.py::test_static_spec_win_tmin and
::test_windowed_matches_unwindowed_likelihood, then the port against the
JAX package with both switches off: its XLA path and its Pallas kernel in
interpret mode, as the JAX package's own tests run it on the CPU, at the
JAX package's tolerances (log L to rtol 1e-5 / atol 0.05, the -inf
pattern exact).  The port's inputs are its own testdata/.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_tpu.models import AbsorptionModel as JaxAbsorptionModel
from mcalf_tpu.models import jax_model as jm
from mcalf_tpu.models import make_jax_forward
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.models.forward import TAU_CONST
from mcalf_torch.ops import voigt_cuda
from mcalf_torch.ops.faddeeva import HJERT_WIN_TMIN

TESTDATA = Path(__file__).parents[1] / "testdata"
_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], ncomp=(8, 11),
    specres=[8.0], Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
)
MODELS = {
    # test_windowing.py's flagship: 22 Harris transitions, 1999 pixels
    "flagship": _CIV,
    # with the asymmetric likelihood, so some rows are -inf
    "asymmlike": dict(_CIV, ncomp=(2, 4), nfill=1, Asymmlike=True),
}


def _models(name):
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    return (JaxAbsorptionModel.from_file(spec, **MODELS[name]),
            AbsorptionModel.from_file(spec, **MODELS[name]))


@pytest.fixture(scope="module")
def flagship():
    return _models("flagship")


def _cube(ndim, n, seed):
    return np.random.default_rng(seed).uniform(0.02, 0.98, size=(n, ndim)).astype(np.float32)


def _assert_ll_close(la, lb):
    la, lb = np.asarray(la, np.float64), np.asarray(lb, np.float64)
    assert np.array_equal(np.isfinite(la), np.isfinite(lb)), (la, lb)
    fin = np.isfinite(la)
    assert np.allclose(la[fin], lb[fin], rtol=1e-5, atol=0.05), np.max(np.abs(la[fin] - lb[fin]))


def test_static_spec_window_switch(flagship, monkeypatch):
    jmod, tmod = flagship
    s = tm.static_spec(tmod)
    assert all(v >= HJERT_WIN_TMIN for v in s.win_tmin) and all(s.harris)
    tab = tmod.transition_table()
    dnu_min = tmod.bounds_lo[tab["pidx"] + 2] * 1e5 * (1e8 / tab["wrest"])
    amp_max = TAU_CONST * 10.0 ** tmod.bounds_hi[tab["pidx"]] * tab["f"] / dnu_min
    assert np.allclose(s.win_tmin, np.maximum(HJERT_WIN_TMIN, np.log(amp_max * 1e8)), rtol=1e-12)
    assert np.allclose(s.win_tmin, jm.static_spec(jmod).win_tmin, rtol=1e-12)
    assert set(tm.line_modes(s)) == {voigt_cuda.MODE_WINDOWED}
    # each package reads its own switch
    monkeypatch.setenv("MCALF_TPU_WINDOW", "0")
    assert tm.static_spec(tmod).win_tmin == s.win_tmin
    assert all(v == 0.0 for v in jm.static_spec(jmod).win_tmin)
    monkeypatch.setenv("MCALF_TORCH_WINDOW", "0")
    s0 = tm.static_spec(tmod)
    assert s0.win_tmin == (0.0,) * s.ntrans and s0.harris == s.harris
    assert tm.line_modes(s0) == (voigt_cuda.MODE_HARRIS,) * s.ntrans
    fwd = make_torch_forward(tmod, "cpu")
    assert fwd.modes.tolist() == [voigt_cuda.MODE_HARRIS] * s.ntrans
    assert not bool(fwd.tmin.any())


def test_window_off_matches_window_on(flagship, monkeypatch):
    """The twin of test_windowing.py::test_windowed_matches_unwindowed_likelihood:
    64 rows, relative log-L difference below 3e-6."""
    _, tmod = flagship
    on = make_torch_forward(tmod, "cpu")
    monkeypatch.setenv("MCALF_TORCH_WINDOW", "0")
    off = make_torch_forward(tmod, "cpu")
    u = torch.from_numpy(_cube(tmod.ndim, 64, seed=9))
    lw = on.loglike_cube(u).double().numpy()
    l0 = off.loglike_cube(u).double().numpy()
    assert np.max(np.abs(lw - l0) / (np.abs(l0) + 1.0)) < 3e-6, np.max(np.abs(lw - l0))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_window_off_matches_jax_xla(name, monkeypatch):
    """Both switches off: the port's likelihood (the fused kernel's plain
    version, every transition MODE_HARRIS) against the JAX package's XLA
    path, which then takes plain hjert_harris."""
    jmod, tmod = _models(name)
    monkeypatch.setenv("MCALF_TPU_WINDOW", "0")
    monkeypatch.setenv("MCALF_TORCH_WINDOW", "0")
    jf = make_jax_forward(jmod, use_pallas=False)
    tf = make_torch_forward(tmod, "cpu")
    assert all(v == 0.0 for v in jf.static.win_tmin)
    u = _cube(tmod.ndim, 48, seed=5)
    if name == "asymmlike":  # rows near the data, so that some pass the outlier test
        u[:24] = 0.5 + 0.05 * (u[:24] - 0.5)
    lt = tf.loglike_cube(torch.from_numpy(u)).numpy()
    _assert_ll_close(np.asarray(jf.loglike_cube(u)), lt)


def test_window_off_matches_jax_pallas_interpret(flagship, monkeypatch):
    """Both switches off: the port against the JAX package's fused Pallas
    kernel (``_ll_kernel``, whose Harris transitions then take the
    plain-Harris branch of ``_accum_tau``) in interpret mode, B = 21."""
    jmod, tmod = flagship
    monkeypatch.setenv("MCALF_TPU_WINDOW", "0")
    monkeypatch.setenv("MCALF_TORCH_WINDOW", "0")
    jf = make_jax_forward(jmod, use_pallas=True)
    assert jf.static.use_pallas and all(v == 0.0 for v in jf.static.win_tmin)
    tf = make_torch_forward(tmod, "cpu")
    u = _cube(tmod.ndim, 21, seed=7)
    _assert_ll_close(np.asarray(jf.loglike_cube(u)), tf.loglike_cube(torch.from_numpy(u)).numpy())
