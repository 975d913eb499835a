"""mcalf_torch's Voigt optical depth and the model-evaluation entry points
(``TorchForward.reconstruct``, ``.chi2``, ``.loglike``) against mcalf_tpu.

The same inputs (unit-cube points from a numpy seed, per-(sample,
transition) tables built by the port) go through both packages: the tau
kernel's plain version against ``voigt_tau_pallas`` in interpret mode, as
the JAX package's own tests run it on the CPU, and the entry points against
``make_jax_forward(..., use_pallas=False)``.

Tolerances: tau to |dtau| / (|tau| + 1e-3) < 3e-5, the bar of
tests/test_voigt_pallas.py; log L to rtol 1e-5 / atol 0.05 with the -inf
pattern exact and chi^2 to rtol 1e-5 / atol 0.1 (float32 sums in another
order, the JAX package's fused-vs-XLA bars); model flux to 1e-5 absolute
(flux is O(1), a few float32 ulps).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcalf_tpu.models import AbsorptionModel as JaxAbsorptionModel
from mcalf_tpu.models import make_jax_forward
from mcalf_tpu.ops.voigt_pallas import voigt_tau_pallas
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.ops import voigt_cuda

TESTDATA = Path(__file__).parents[1] / "testdata"
MULTICOMP = str(TESTDATA / "civ_mock_spec_multicomp.txt")

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    specres=[8.0], Nrange=[12.0, 14.5], zrange=[2.99, 3.01],
)
MODELS = {
    # testdata/fit.cfg: 22 Harris-regime transitions, all windowed
    "flagship": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0]),
    # fit.cfg with brange = 3, 40: all 22 transitions strongly damped
    "narrow": dict(_CIV, ncomp=(8, 11), brange=[3.0, 40.0]),
    # the narrow-line model at a CPU-sized ncomp
    "narrow_small": dict(_CIV, ncomp=(2, 3), brange=[3.0, 40.0]),
    # test_windowing.py's mixed model: CIV and the filler windowed, HI 1215
    # strongly damped
    "mixed": dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
        brange=[5.0, 40.0], zrange=[2.99, 3.01],
    ),
}


def _models(name):
    kw = MODELS[name]
    return JaxAbsorptionModel.from_file(MULTICOMP, **kw), AbsorptionModel.from_file(MULTICOMP, **kw)


def _cube(ndim, n, seed, clustered=False, layout=None):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.02, 0.98, size=(n, ndim))
    if clustered:
        startind, ncompmax = layout[0], layout[1]
        zcols = [startind + 2 + 3 * i for i in range(ncompmax)]
        u[:, zcols] = 0.5 + rng.normal(0.0, 2e-3, size=(n, len(zcols)))
    return u.astype(np.float32)


def _tau_inputs(fwd, u):
    s, c = fwd.static, fwd.consts()
    u = torch.from_numpy(u)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    dz, gain, av, dnu = tm._line_tables(tm.cube_to_params_core(u, c), c, s, dz)
    return dz, gain, av, dnu, c["d0"], c["c_over_wave"]


@pytest.mark.parametrize(
    "name,flags",
    [("narrow", "none"), ("flagship", "windowed"), ("mixed", "model")],
)
def test_tau_plain_matches_pallas(name, flags):
    """B = 13, not a multiple of the TPU's 8-row block.  'none': no flags,
    every transition the full hjert on both sides."""
    _, tmod = _models(name)
    fwd = make_torch_forward(tmod, "cpu")
    s = fwd.static
    if flags == "none":
        assert not any(s.harris)
        harris, win, modes = (), (), torch.full((s.ntrans,), 2, dtype=torch.int32)
        tmin = torch.zeros(s.ntrans)
    else:
        harris, win, modes, tmin = s.harris, s.win_tmin, fwd.modes, fwd.tmin
    if flags == "windowed":
        assert all(m == voigt_cuda.MODE_WINDOWED for m in modes.tolist())
    if flags == "model":
        assert set(modes.tolist()) == {voigt_cuda.MODE_WINDOWED, voigt_cuda.MODE_HJERT}
    args = _tau_inputs(fwd, _cube(s.ndim, 13, seed=5))
    got = voigt_cuda.voigt_tau_plain(*args, tmin, modes).numpy()
    want = np.asarray(voigt_tau_pallas(
        *(jnp.asarray(a.numpy()) for a in args), interpret=True,
        harris=harris, win_tmin=win,
    ))
    assert got.shape == want.shape == (13, s.npix)
    err = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert np.max(err) < 3e-5, np.max(err)
    assert np.max(want) > 1.0  # lines, not just continuum


def test_tau_wrapper_on_cpu_is_the_plain_version():
    _, tmod = _models("mixed")
    fwd = make_torch_forward(tmod, "cpu")
    args = _tau_inputs(fwd, _cube(fwd.ndim, 4, seed=6))
    before = voigt_cuda.tau_launches
    got = voigt_cuda.voigt_tau(*args, fwd.tmin, fwd.modes)
    want = voigt_cuda.voigt_tau_plain(*args, fwd.tmin, fwd.modes)
    assert torch.equal(got, want)
    assert voigt_cuda.tau_launches == before


def _close(got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.allclose(got[fin], want[fin], rtol=rtol, atol=atol), np.max(
        np.abs(got[fin] - want[fin])
    )


@pytest.mark.parametrize("name", ("narrow_small", "mixed"))
@pytest.mark.parametrize("conv_mode", ("same_edge", "wrap"))
def test_entry_points_match_xla(name, conv_mode, monkeypatch):
    """reconstruct, chi2 and loglike against the JAX package's XLA path;
    on the CPU each runs the plain tau or fused version, never a kernel."""
    jmod, tmod = _models(name)
    jf = make_jax_forward(jmod, conv_mode=conv_mode, use_pallas=False)
    fwd = make_torch_forward(tmod, "cpu", conv_mode=conv_mode)
    assert fwd.static.conv_mode == conv_mode
    u = np.concatenate([
        _cube(jmod.ndim, 8, seed=9),
        _cube(jmod.ndim, 8, seed=10, clustered=True, layout=jmod.canon_layout()),
    ])
    p = np.asarray(jf.cube_to_params(u))
    tp = torch.from_numpy(p.copy())

    calls = []
    plain = voigt_cuda.voigt_tau_plain
    monkeypatch.setattr(
        voigt_cuda, "voigt_tau_plain", lambda *a: calls.append(1) or plain(*a)
    )
    before = (voigt_cuda.launches, voigt_cuda.tau_launches)
    flux = fwd.reconstruct(tp).numpy()
    assert np.max(np.abs(flux - np.asarray(jf.reconstruct(p)))) < 1e-5
    _close(fwd.chi2(tp).numpy(), jf.chi2(p), rtol=1e-5, atol=0.1)
    _close(fwd.loglike(tp).numpy(), jf.loglike(p), rtol=1e-5, atol=0.05)
    _close(fwd.loglike_cube(torch.from_numpy(u)).numpy(), jf.loglike_cube(u),
           rtol=1e-5, atol=0.05)
    # one plain tau per reconstruct and chi2, one per loglike/loglike_cube
    # (through reconstruct outside 'same_edge', inside the fused twin there)
    assert len(calls) == 4
    assert (voigt_cuda.launches, voigt_cuda.tau_launches) == before
    # leading batch axes flow through
    assert fwd.reconstruct(tp.reshape(2, 8, -1)).shape == (2, 8, fwd.npix)
    assert fwd.chi2(tp[0]).shape == ()
