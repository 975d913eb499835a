"""mcalf_torch's forward model and fused likelihood against mcalf_tpu.

The same inputs (unit-cube points drawn from a numpy seed, the JAX
package's own constant tables carried across by ``consts_from_numpy``) go
through both packages.  The JAX side runs as its own tests run it on the
CPU: the XLA path, or the Pallas kernels in interpret mode.

Tolerances (the JAX package's own, tests/test_voigt_pallas.py and
tests/test_windowing.py): log L to rtol 1e-5 / atol 0.05 and chi^2 to
rtol 1e-5 / atol 0.1, since the float32 sums run in another order; chi^2
against the WINDOWED Pallas kernel to atol 0.5 (that kernel drops up to
amp_max e^{-tmin} < 1e-8 of tau on some blocks); asymmlike -inf patterns
exactly.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcalf_tpu.config import readconfig
from mcalf_tpu.models import AbsorptionModel as JaxAbsorptionModel
from mcalf_tpu.models import make_jax_forward
from mcalf_tpu.models import jax_model as jm
from mcalf_tpu.models.forward import CCGS
from mcalf_tpu.ops.voigt_pallas import likelihood_pallas
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.ops import voigt_cuda

TESTDATA = Path(__file__).parents[1] / "testdata"


def _flagship_kwargs():
    cp = readconfig(str(TESTDATA / "fit.cfg"))
    return dict(
        fitrange=cp["wavefit"],
        fitlines=cp["linelist"],
        ncomp=cp["ncomp"],
        specres=cp["specres"],
        contval=cp["contval"],
        Nrange=cp["Nrange"],
        brange=cp["brange"],
        zrange=cp["zrange"],
    )


@pytest.fixture(scope="module")
def flagship():
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    kw = _flagship_kwargs()
    return JaxAbsorptionModel.from_file(spec, **kw), AbsorptionModel.from_file(spec, **kw)


def _port_from_jax_consts(jmodel):
    """TorchForward built from the JAX package's own constant tables."""
    s = tm.static_spec(jmodel)
    c = tm.consts_from_numpy(jm.build_consts(jmodel), "cpu")
    return tm.TorchForward(s, c)


def _cube(ndim, n, seed, lo=0.02, hi=0.98):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, ndim)).astype(np.float32)


def _assert_ll_close(la, lb, rtol=1e-5, atol=0.05):
    la = np.asarray(la, np.float64)
    lb = np.asarray(lb, np.float64)
    assert la.shape == lb.shape
    assert np.array_equal(np.isfinite(la), np.isfinite(lb)), (la, lb)
    fin = np.isfinite(la)
    assert np.allclose(la[fin], lb[fin], rtol=rtol, atol=atol), np.max(
        np.abs(la[fin] - lb[fin])
    )


# ---------------------------------------------------------------------------
# Host copies: AbsorptionModel, StaticSpec, build_consts
# ---------------------------------------------------------------------------

def test_absorption_model_copy_matches(flagship):
    jmod, tmod = flagship
    for attr in ("ndim", "npix", "startind", "endind", "velstep", "gauss_cdf",
                 "gracenum", "freecont", "freespecres"):
        assert getattr(jmod, attr) == getattr(tmod, attr), attr
    for attr in ("bounds_lo", "bounds_hi", "obj_wl", "obj", "obj_noise", "valid"):
        np.testing.assert_array_equal(getattr(jmod, attr), getattr(tmod, attr))
    assert jmod.canon_layout() == tmod.canon_layout()
    assert jmod.kernel_half_size() == tmod.kernel_half_size()
    jt, tt = jmod.transition_table(), tmod.transition_table()
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k])
    p = tmod.scale_cube(_cube(tmod.ndim, 1, 3)[0])
    np.testing.assert_array_equal(jmod.reconstruct_spec(p), tmod.reconstruct_spec(p))
    assert jmod.lnlhood(p) == tmod.lnlhood(p)


def test_static_spec_and_consts_match_jax(flagship):
    jmod, tmod = flagship
    js = jm.static_spec(jmod)
    ts = tm.static_spec(tmod)
    for f in dataclasses.fields(ts):
        assert getattr(ts, f.name) == getattr(js, f.name), f.name
    # the flagship shapes: 22 Harris-regime, windowed transitions, 23 taps
    assert (ts.ndim, ts.ntrans, ts.npix, ts.half) == (34, 22, 1999, 11)
    assert all(ts.harris) and min(ts.win_tmin) >= 21.0
    jc = jm.build_consts(jmod)
    tc = tm.build_consts(tmod)
    assert set(jc) == set(tc)
    for k in jc:
        a, b = np.asarray(jc[k]), np.asarray(tc[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# The fused likelihood's plain version vs the Pallas kernels and XLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("windowed", (True, False))
def test_fused_plain_matches_pallas_flagship(flagship, windowed):
    """B = 21 (not a multiple of the TPU's 8-row block): with windowing the
    JAX package runs _ll_kernel_win, without it _ll_kernel."""
    jmod, _ = flagship
    fwd = _port_from_jax_consts(jmod)
    s = fwd.static
    if not windowed:
        s = dataclasses.replace(s, win_tmin=(0.0,) * s.ntrans)
        fwd = tm.TorchForward(s, {k: v for k, v in fwd.consts().items() if k != "tmin"})
    c = fwd.consts()
    u = torch.from_numpy(_cube(s.ndim, 21, seed=7))
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    args = tm.fused_args(tm.cube_to_params_core(u, c), c, s, dz=dz)
    chi2, n4, n5 = voigt_cuda.fused_loglike_plain(
        *args, half=s.half, asymm=False
    )
    dzn, gain, av, dnu, d0, cw, data, ivar, inn, kern, cont, _, _ = [
        a.numpy() for a in args
    ]
    jc = jm.build_consts(jmod)
    pal = likelihood_pallas(
        jnp.asarray(dzn), jnp.asarray(gain), jnp.asarray(av), jnp.asarray(dnu),
        jnp.asarray(d0), jnp.asarray(cw), jnp.asarray(data), jnp.asarray(ivar),
        jnp.asarray(inn), jnp.asarray(np.broadcast_to(kern, (21, kern.shape[1]))),
        jnp.asarray(np.broadcast_to(cont, (21,))),
        zmid=jc["zmid"], nu0=CCGS * np.asarray(jc["inv_wrest_cm"]),
        wingrid=jc["wingrid"], interpret=True, harris=s.harris, half=s.half,
        asymm=False, win_tmin=s.win_tmin if windowed else (),
    )
    want = np.asarray(pal[0], np.float64)
    got = chi2.numpy().astype(np.float64)
    atol = 0.5 if windowed else 0.1
    assert np.allclose(got, want, rtol=1e-5, atol=atol), np.max(np.abs(got - want))
    assert np.all(n4.numpy() == 0) and np.all(n5.numpy() == 0)


def test_loglike_cube_matches_xla_flagship(flagship):
    jmod, tmod = flagship
    u = _cube(jmod.ndim, 21, seed=8)
    want = np.asarray(make_jax_forward(jmod, use_pallas=False).loglike_cube(u))
    got_jc = _port_from_jax_consts(jmod).loglike_cube(torch.from_numpy(u)).numpy()
    got = make_torch_forward(tmod, "cpu").loglike_cube(torch.from_numpy(u)).numpy()
    _assert_ll_close(got_jc, want)
    np.testing.assert_array_equal(got, got_jc)
    # leading batch axes flow through
    got2 = make_torch_forward(tmod, "cpu").loglike_cube(
        torch.from_numpy(u.reshape(3, 7, -1))
    )
    assert got2.shape == (3, 7)
    np.testing.assert_allclose(got2.reshape(-1).numpy(), got, rtol=1e-6)


def test_asymmlike_multicomp_matches_jax():
    """test_voigt_pallas.py's trans-dimensional asymmlike model with a
    filler: the -inf rejection pattern must match exactly."""
    jmod = JaxAbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(2, 4),
        nfill=1,
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
        Asymmlike=True,
    )
    fwd = _port_from_jax_consts(jmod)
    assert fwd.static.asymmlike
    rng = np.random.default_rng(7)
    u = rng.uniform(0.02, 0.98, size=(21, jmod.ndim)).astype(np.float32)
    # plus points near the mock truth region so some pass the asymmlike gate
    u[:4, jmod.startind] = 0.99
    got = fwd.loglike_cube(torch.from_numpy(u)).numpy()
    xla = np.asarray(make_jax_forward(jmod, use_pallas=False).loglike_cube(u))
    pal = np.asarray(make_jax_forward(jmod, use_pallas=True).loglike_cube(u))
    _assert_ll_close(got, xla)
    _assert_ll_close(got, pal)
    assert not np.all(np.isfinite(got))


def test_floating_specres_and_cont_matches_xla():
    """Floating specres (per-sample LSF kernels) + floating continuum +
    asymmlike, near the mock truth so the asymmlike gate accepts
    (test_voigt_pallas.py's truth-perturbation construction)."""
    jmod = JaxAbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11),
        specres=[6.0, 10.0],
        contval=[0.9, 1.1],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
        Asymmlike=True,
    )
    lo, hi = jmod.bounds_lo, jmod.bounds_hi
    zs = [2.999, 2.9995, 3.0, 3.001, 3.0005, 3.0015, 3.002, 3.0025,
          3.0035, 3.0039]
    Ns = [13.6, 13.0, 13.8, 13.6, 13.2, 13.4, 13.5, 14.0, 14.2, 13.7]
    bs = [17.5, 10.5, 20.0, 25.0, 15.0, 30.0, 10.0, 25.0, 15.0, 20.0]
    p = [8.0, 1.0, 10.5]
    for N, z, b in zip(Ns, zs, bs):
        p += [N, z, b]
    p += [13.0, 3.0, 20.0]
    u0 = (np.array(p) - lo) / (hi - lo)
    rng = np.random.default_rng(1)
    u = np.clip(
        u0[None] + rng.normal(0, 5e-4, size=(37, jmod.ndim)), 1e-4, 1 - 1e-4
    ).astype(np.float32)
    ur = rng.uniform(0.05, 0.95, size=(16, jmod.ndim)).astype(np.float32)
    u = np.concatenate([u, ur])
    fwd = _port_from_jax_consts(jmod)
    got = fwd.loglike_cube(torch.from_numpy(u)).numpy()
    want = np.asarray(make_jax_forward(jmod, use_pallas=False).loglike_cube(u))
    _assert_ll_close(got, want)
    assert np.isfinite(got[:37]).sum() > 20


def test_gaussian_priors_match_jax():
    """[components] gpriors: the Gaussian-prior term on top of the fused
    likelihood, 'none' entries unconstrained."""
    kw = dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1), specres=[8.0], Nrange=[12.0, 14.5], brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
        Gpriors=["none", "none", "13.8", "0.2", "none", "none", "15", "3"],
    )
    spec = str(TESTDATA / "civ_mock_spec.txt")
    jmod = JaxAbsorptionModel.from_file(spec, **kw)
    tmod = AbsorptionModel.from_file(spec, **kw)
    fwd = make_torch_forward(tmod, "cpu", gpriors=True)
    assert fwd.static.has_gpriors
    u = _cube(jmod.ndim, 9, seed=12, lo=0.3, hi=0.7)
    want = np.asarray(
        make_jax_forward(jmod, gpriors=True, use_pallas=False).loglike_cube(u)
    )
    got = fwd.loglike_cube(torch.from_numpy(u)).numpy()
    _assert_ll_close(got, want)
    plain = make_torch_forward(tmod, "cpu").loglike_cube(torch.from_numpy(u)).numpy()
    assert np.all(got < plain)


_STRONG_DAMPING = {
    # the narrow-line model: fit.cfg's CIV doublet with brange = 3, 40 (every
    # transition above HARRIS_A_MAX), ncomp cut to 2-3 for CPU time
    "narrow": dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(2, 3), specres=[8.0], Nrange=[12.0, 14.5], brange=[3.0, 40.0],
        zrange=[2.99, 3.01],
    ),
    # test_windowing.py's mixed model: HI 1215 strongly damped, CIV 1548 and
    # the filler windowed Harris
    "mixed": dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
        brange=[5.0, 40.0], zrange=[2.99, 3.01],
    ),
}


@pytest.mark.parametrize("name", sorted(_STRONG_DAMPING))
def test_strong_damping_loglike_matches_jax(name):
    """The port's loglike_cube (the fused plain version, mode 2 on the
    damped transitions) against the JAX package's XLA path and its
    interpreted Pallas kernel, on a prior-spread and a z-clustered batch.
    The mixed model runs the windowed Pallas kernel, held to its own bar
    (atol 0.5, test_windowing.py:272)."""
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    kw = _STRONG_DAMPING[name]
    jmod = JaxAbsorptionModel.from_file(spec, **kw)
    fwd = make_torch_forward(AbsorptionModel.from_file(spec, **kw), "cpu")
    assert voigt_cuda.MODE_HJERT in fwd.modes.tolist()
    startind, ncompmax = jmod.canon_layout()[:2]
    zcols = [startind + 2 + 3 * i for i in range(ncompmax)]
    rng = np.random.default_rng(13)
    u = rng.uniform(0.02, 0.98, size=(16, jmod.ndim))
    u[8:, zcols] = 0.5 + rng.normal(0.0, 2e-3, size=(8, len(zcols)))
    u = u.astype(np.float32)
    got = fwd.loglike_cube(torch.from_numpy(u)).numpy()
    xla = np.asarray(make_jax_forward(jmod, use_pallas=False).loglike_cube(u))
    pal = np.asarray(make_jax_forward(jmod, use_pallas=True).loglike_cube(u))
    _assert_ll_close(got, xla)
    _assert_ll_close(got, pal, atol=0.5 if name == "mixed" else 0.05)


def test_reconstruct_matches_xla(flagship):
    jmod, _ = flagship
    u = _cube(jmod.ndim, 5, seed=3)
    jf = make_jax_forward(jmod, use_pallas=False)
    p = np.asarray(jf.cube_to_params(u))
    want = np.asarray(jf.reconstruct(p))
    fwd = _port_from_jax_consts(jmod)
    got = fwd.reconstruct(torch.from_numpy(p.copy())).numpy()
    assert np.max(np.abs(got - want)) < 1e-5
    # lo + u (hi - lo): one float32 rounding apart (XLA may fuse the fma)
    np.testing.assert_allclose(
        fwd.cube_to_params(torch.from_numpy(u)).numpy(), p, rtol=2.0**-23
    )


def test_non_harris_transition_raises():
    """HI 1215 at b >= 5 km/s has prior-bound damping above HARRIS_A_MAX
    (test_windowing.py's mixed model): it builds, its non-Harris
    transitions take the full hjert (mode 2), and only a mode outside the
    three the kernels know raises, on the CPU route too."""
    kw = dict(
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3),
        nfill=1,
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[5.0, 40.0],
        zrange=[2.99, 3.01],
    )
    tmod = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec_multicomp.txt"), **kw)
    s = tm.static_spec(tmod)
    assert s.harris == (True, False, True, False, True, False, True)
    fwd = make_torch_forward(tmod, "cpu")
    assert fwd.modes.tolist() == [1, 2, 1, 2, 1, 2, 1]
    T, P = s.ntrans, s.npix
    z = torch.zeros
    bad = torch.full((T,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        voigt_cuda.fused_loglike(
            z(2, T), z(2, T), z(2, T), torch.ones(2, T), z(T, P), z(P), z(P),
            z(P), z(P), torch.ones(1, 2 * s.half + 1), torch.ones(1), z(T), bad,
            half=s.half, asymm=False,
        )


def test_kernel_wrapper_validation():
    """What the CUDA route would refuse is refused before any launch: line
    tables or an LSF too large for a CTA's shared memory.  A long spectrum
    is split over a cluster of CTAs and is no longer refused."""
    with pytest.raises(ValueError, match="shared memory"):
        voigt_cuda.check_supported(1700, 10, 0)
    with pytest.raises(ValueError, match="shared memory"):
        voigt_cuda.check_supported(2, 200000, 30000)
    voigt_cuda.check_supported(22, 1999, 11)
    voigt_cuda.check_supported(2, 70000, 11)
