"""mcalf_torch.ops against mcalf_tpu.ops: the Harris-regime special
functions and the LSF convolution, elementwise on the same inputs.

Tolerances: the two packages evaluate the same float32 formulas, but XLA
and PyTorch differ in exp and in fused multiply-add contraction, so values
may differ by a float32 ulp or two (measured <= 1.6 ulp on these grids).
RTOL = 4 ulp, one ulp being 2^-23 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcalf_tpu.ops import convolve as jconv
from mcalf_tpu.ops import faddeeva as jfad
from mcalf_torch.ops import convolve as tconv
from mcalf_torch.ops import faddeeva as tfad

RTOL = 4 * 2.0**-23

# the test_faddeeva.py grids
U_DAWSN = np.concatenate(
    [np.linspace(-10, 10, 40001), np.linspace(10, 500, 5001)]
).astype(np.float32)
U_HARRIS = np.concatenate(
    [np.linspace(0, 30, 30001), np.linspace(30, 500, 5001)]
).astype(np.float32)
A_HARRIS = (1e-7, 1e-5, 1e-4, 3e-4, 1e-3)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert np.max(err) <= rtol, np.max(err)


def test_dawsn_matches_jax():
    got = tfad.dawsn(torch.from_numpy(U_DAWSN)).numpy()
    want = np.asarray(jfad.dawsn(jnp.asarray(U_DAWSN)))
    _close(got, want)
    # odd, as the JAX version
    assert np.array_equal(got, -tfad.dawsn(torch.from_numpy(-U_DAWSN)).numpy())


@pytest.mark.parametrize("a", A_HARRIS)
def test_hjert_harris_matches_jax(a):
    got = tfad.hjert_harris(torch.from_numpy(U_HARRIS), torch.tensor(a)).numpy()
    want = np.asarray(jfad.hjert_harris(jnp.asarray(U_HARRIS), jnp.float32(a)))
    _close(got, want)


@pytest.mark.parametrize("a", (1e-5, 1e-4, 1e-3))
def test_hjert_wing_matches_jax(a):
    u = np.linspace(np.sqrt(jfad.HJERT_WIN_TMIN), 60.0, 4001).astype(np.float32)
    got = tfad.hjert_wing(torch.from_numpy(u), torch.tensor(a)).numpy()
    want = np.asarray(jfad.hjert_wing(jnp.asarray(u), jnp.float32(a)))
    _close(got, want)


@pytest.mark.parametrize("tmin", (jfad.HJERT_WIN_TMIN, 23.5))
def test_hjert_harris_win_matches_jax(tmin):
    for a in (1e-5, 3e-4, 1e-3):
        got = tfad.hjert_harris_win(
            torch.from_numpy(U_HARRIS), torch.tensor(a), tmin
        ).numpy()
        want = np.asarray(
            jfad.hjert_harris_win(jnp.asarray(U_HARRIS), np.float32(a), tmin)
        )
        _close(got, want)


def test_harris_broadcast_column_matches_jax():
    # a as a per-sample column against a pixel axis (the fused-tau layout)
    u = np.linspace(0, 20, 2048, dtype=np.float32)[None, :].repeat(4, axis=0)
    a = np.array([[1e-4], [2e-4], [5e-4], [1e-3]], np.float32)
    got = tfad.hjert_harris(torch.from_numpy(u), torch.from_numpy(a)).numpy()
    want = np.asarray(jfad.hjert_harris(jnp.asarray(u), jnp.asarray(a)))
    assert got.shape == (4, 2048)
    _close(got, want)


def test_constants_match_jax():
    for name in ("_DAWSN_P1", "_DAWSN_P2", "_DAWSN_P3", "_DAWSN_P4"):
        assert tuple(getattr(jfad, name)) == getattr(tfad, name[1:])
    assert tfad.HARRIS_A_MAX == jfad.HARRIS_A_MAX
    assert tfad.HJERT_WIN_TMIN == jfad.HJERT_WIN_TMIN
    assert tfad.TWO_OVER_SQRTPI == jfad._TWO_OVER_SQRTPI
    assert tconv.FWHM_TO_SIGMA == jconv.FWHM_TO_SIGMA
    assert tconv.SUPPORT_SIGMAS == jconv.SUPPORT_SIGMAS
    for fwhm, step in ((8.0, 0.96755), (6.0, 2.5), (40.0, 1.0)):
        assert tconv.kernel_half_size(fwhm, step) == jconv.kernel_half_size(fwhm, step)


def test_gaussian_kernel_matches_jax():
    sig = np.array([0.7, 1.5, 3.4, 4.0], np.float32)
    for half in (0, 3, 11):
        got = tconv.gaussian_kernel(torch.from_numpy(sig), half).numpy()
        want = np.asarray(jconv.gaussian_kernel(jnp.asarray(sig), half))
        assert got.shape == (4, 2 * half + 1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
    # scalar sigma -> (K,)
    got = tconv.gaussian_kernel(torch.tensor(3.4), 11).numpy()
    want = np.asarray(jconv.gaussian_kernel(jnp.float32(3.4), 11))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("mode", ("same_edge", "same", "wrap"))
@pytest.mark.parametrize("per_sample", (False, True))
def test_lsf_convolve_matches_jax(mode, per_sample):
    rng = np.random.default_rng(11)
    flux = rng.uniform(0.0, 1.0, size=(5, 301)).astype(np.float32)
    sig = rng.uniform(1.0, 3.5, size=(5,)).astype(np.float32)
    half = 9
    if per_sample:
        kern = np.array(jconv.gaussian_kernel(jnp.asarray(sig), half))
    else:
        kern = np.array(jconv.gaussian_kernel(jnp.float32(2.2), half))
    got = tconv.lsf_convolve(
        torch.from_numpy(flux), torch.from_numpy(kern), mode=mode
    ).numpy()
    want = np.asarray(jconv.lsf_convolve(jnp.asarray(flux), jnp.asarray(kern), mode=mode))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    if mode == "same_edge":
        np.testing.assert_array_equal(got[:, :half], flux[:, :half])
        np.testing.assert_array_equal(got[:, -half:], flux[:, -half:])


def test_lsf_convolve_rejects_bad_input():
    with pytest.raises(ValueError):
        tconv.lsf_convolve(torch.ones(10), torch.ones(4))
    with pytest.raises(ValueError):
        tconv.lsf_convolve(torch.ones(10), torch.ones(3), mode="reflect")
