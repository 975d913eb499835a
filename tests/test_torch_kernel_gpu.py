"""The hand-written CUDA kernel on a card, against its plain PyTorch
version on the same inputs.  Marked ``gpu``: they skip without a CUDA
device.  This file imports no jax, so on a machine with a card and without
jax it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

Tolerance: chi^2 to rtol 1e-5 / atol 0.1 (float32 sums in another order;
the JAX package's fused-vs-XLA bar on log L is rtol 1e-5 / atol 0.05).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.ops import voigt_cuda

TESTDATA = Path(__file__).parents[1] / "testdata"

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def fwd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11), specres=[8.0], Nrange=[12.0, 14.5],
        brange=[10.0, 40.0], zrange=[2.99, 3.01], Asymmlike=True,
    )
    return make_torch_forward(model, "cuda")


def _args(fwd, B, seed):
    s, c = fwd.static, fwd.consts()
    u = torch.from_numpy(
        np.random.default_rng(seed).uniform(0.02, 0.98, (B, s.ndim)).astype(np.float32)
    ).cuda()
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    return tm.fused_args(tm.cube_to_params_core(u, c), c, s, dz=dz)


@pytest.mark.parametrize("B", (100, 37, 1))
def test_kernel_matches_plain(fwd, B):
    s = fwd.static
    args = _args(fwd, B, seed=B)
    before = voigt_cuda.launches
    k = voigt_cuda.fused_loglike(*args, harris=s.harris, half=s.half, asymm=True)
    assert voigt_cuda.launches == before + 1
    p = voigt_cuda.fused_loglike_plain(*args, half=s.half, asymm=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(), rtol=1e-5, atol=0.1)
    # outlier counts: equal up to residuals rounding across the 4/5 sigma line
    for a, b in zip(k[1:], p[1:]):
        assert np.max(np.abs(a.cpu().numpy() - b.cpu().numpy())) <= 1.0


def test_kernel_rejects_bad_inputs(fwd):
    s = fwd.static
    args = list(_args(fwd, 8, seed=1))
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        voigt_cuda.fused_loglike(*bad, harris=s.harris, half=s.half, asymm=False)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()  # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        voigt_cuda.fused_loglike(*bad, harris=s.harris, half=s.half, asymm=False)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError):
        voigt_cuda.fused_loglike(*bad, harris=s.harris, half=s.half, asymm=False)


def test_empty_batch(fwd):
    s = fwd.static
    args = _args(fwd, 0, seed=2)
    chi2, n4, n5 = voigt_cuda.fused_loglike(*args, harris=s.harris, half=s.half, asymm=True)
    assert chi2.shape == n4.shape == n5.shape == (0,)


def test_kernel_runs_on_the_current_stream(fwd):
    """The launch goes to PyTorch's current stream (a side stream here), and
    agrees with a launch on the default stream."""
    s = fwd.static
    args = _args(fwd, 64, seed=3)
    kw = dict(harris=s.harris, half=s.half, asymm=True)
    want = voigt_cuda.fused_loglike(*args, **kw)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = voigt_cuda.fused_loglike(*args, **kw)[0]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
