"""``mcalf_torch.ops.reference_style`` (the reference's formulation of the
likelihood, a benchmark's yardstick) against the JAX package's original
and against the port's own plain likelihood, on the flagship model and the
narrow one (``brange = 3, 40``: every transition in the strong-damping
branch), from seeded rows.  Tolerance: the JAX package's fused-vs-XLA bar,
rtol 1e-5 and atol 0.05 on log L, with the pattern of non-finite values
exact.  The JAX original misses that bar against its own package's
likelihood (its float32 Doppler offset), so it is held to the bar through
the JAX package's likelihood, and to the original within the original's
own distance from it.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mcalf_tpu.models import AbsorptionModel as JaxModel
from mcalf_tpu.models import make_jax_forward
from mcalf_tpu.ops.reference_style import make_reference_style_loglike as jax_reference_style
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.ops import reference_style
from mcalf_torch.ops.reference_style import make_reference_style_loglike

TESTDATA = Path(__file__).parents[1] / "testdata"
_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], specres=[8.0],
    Nrange=[12.0, 14.5], zrange=[2.99, 3.01], ncomp=(8, 11),
)
MODELS = {"flagship": dict(_CIV, brange=[10.0, 40.0]),
          "narrow": dict(_CIV, brange=[3.0, 40.0])}
RTOL, ATOL = 1e-5, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(model, B, seed):
    """Physical parameters inside the prior box, as bench.py draws them."""
    lo, hi = (np.asarray(b, np.float64) for b in zip(*model.bounds))
    rng = np.random.default_rng(seed)
    return (lo + rng.uniform(0.2, 0.8, size=(B, model.ndim)) * (hi - lo)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    name = request.param
    path = str(TESTDATA / "civ_mock_spec.txt")
    tm = AbsorptionModel.from_file(path, **MODELS[name])
    jm = JaxModel.from_file(path, **MODELS[name])
    p = _rows(tm, 12, seed=7 if name == "flagship" else 8)
    return name, tm, jm, p


def test_matches_the_jax_package(case):
    """Against the JAX package's likelihood at the bar; against its
    reference_style within the bar plus that original's own distance from
    its package's likelihood: the original forms the Doppler offset in
    float32 (up to 2e-3 off in u at z = 3; ROADMAP Queue 3), the port in
    float64."""
    name, tm, jm, p = case
    got = make_reference_style_loglike(tm, device="cpu")(torch.from_numpy(p)).numpy()
    package = np.asarray(make_jax_forward(jm).loglike(jax.numpy.asarray(p)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(package))
    np.testing.assert_allclose(got, package, rtol=RTOL, atol=ATOL)
    original = np.asarray(jax_reference_style(jm)(jax.numpy.asarray(p)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(original))
    own = np.abs(original - package)
    assert np.all(np.abs(got - original) <= own + ATOL + RTOL * np.abs(original)), (
        got - original, own)


def test_matches_the_ports_plain_likelihood(case):
    name, tm, jm, p = case
    fwd = make_torch_forward(tm, device="cpu")
    want = fwd.loglike(torch.from_numpy(p)).numpy()
    got = make_reference_style_loglike(tm, device="cpu")(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_naive_series_matches_the_jax_one():
    from mcalf_tpu.ops.reference_style import _hjert_naive as jax_naive

    rng = np.random.default_rng(3)
    x = rng.uniform(-15, 15, 4000).astype(np.float32)
    a = (10.0 ** rng.uniform(-4, 0.5, 4000)).astype(np.float32)
    want = np.asarray(jax_naive(jax.numpy.asarray(x), jax.numpy.asarray(a)))
    got = reference_style._hjert_naive(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_runs_on_the_card_unless_asked():
    tm = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec.txt"), **MODELS["flagship"])
    p = torch.from_numpy(_rows(tm, 2, seed=1))
    if torch.cuda.is_available():
        assert make_reference_style_loglike(tm)(p.cuda()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make_reference_style_loglike(tm)
    assert make_reference_style_loglike(tm, device="cpu")(p).shape == (2,)
