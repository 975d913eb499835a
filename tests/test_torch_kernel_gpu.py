"""The hand-written CUDA kernels on a card, against their plain PyTorch
versions on the same inputs.  Marked ``gpu``: they skip without a CUDA
device.  This file imports no jax, so on a machine with a card and without
jax it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

Tolerances: chi^2 to rtol 1e-5 / atol 0.1 and log L to rtol 1e-5 / atol
0.05 with the -inf pattern exact (float32 sums in another order; the JAX
package's fused-vs-XLA bars); tau to |dtau| / (|tau| + 1e-3) < 3e-5 (the
JAX package's tau bar).
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

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    specres=[8.0], Nrange=[12.0, 14.5], zrange=[2.99, 3.01],
)
MODELS = {
    # the flagship with the asymmetric likelihood: all windowed Harris
    "flagship": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0], Asymmlike=True),
    # brange = 3, 40: all 22 transitions strongly damped (full hjert)
    "narrow": dict(_CIV, ncomp=(8, 11), brange=[3.0, 40.0], Asymmlike=True),
    # CIV 1548 + HI 1215 + filler: windowed Harris and full hjert
    "mixed": dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
        brange=[5.0, 40.0], zrange=[2.99, 3.01],
    ),
}


def _forward(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"), **MODELS[name]
    )
    return make_torch_forward(model, "cuda")


@pytest.fixture(scope="module")
def fwd():
    return _forward("flagship")


@pytest.fixture(scope="module", params=("narrow", "mixed"))
def damped(request):
    return _forward(request.param)


@pytest.fixture(scope="module", params=("flagship", "narrow", "mixed"))
def any_fwd(request):
    return _forward(request.param)


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
    k = voigt_cuda.fused_loglike(*args, half=s.half, asymm=True)
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
        voigt_cuda.fused_loglike(*bad, half=s.half, asymm=False)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()  # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        voigt_cuda.fused_loglike(*bad, half=s.half, asymm=False)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError):
        voigt_cuda.fused_loglike(*bad, half=s.half, asymm=False)
    bad = list(args)
    bad[12] = args[12].long()
    with pytest.raises(ValueError, match="int32"):
        voigt_cuda.fused_loglike(*bad, half=s.half, asymm=False)
    with pytest.raises(ValueError, match="int32"):
        voigt_cuda.voigt_tau(*bad[:6], *bad[11:])


def test_empty_batch(fwd):
    s = fwd.static
    args = _args(fwd, 0, seed=2)
    chi2, n4, n5 = voigt_cuda.fused_loglike(*args, half=s.half, asymm=True)
    assert chi2.shape == n4.shape == n5.shape == (0,)


def test_kernel_runs_on_the_current_stream(fwd):
    """The launch goes to PyTorch's current stream (a side stream here), and
    agrees with a launch on the default stream."""
    s = fwd.static
    args = _args(fwd, 64, seed=3)
    kw = dict(half=s.half, asymm=True)
    want = voigt_cuda.fused_loglike(*args, **kw)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = voigt_cuda.fused_loglike(*args, **kw)[0]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("B", (100, 37, 1))
def test_damped_kernel_matches_plain(damped, B):
    """The strong-damping (mode 2) branch of the fused kernel: log L."""
    s, c = damped.static, damped.consts()
    assert 2 in damped.modes.tolist()
    u = torch.from_numpy(
        np.random.default_rng(B).uniform(0.02, 0.98, (B, s.ndim)).astype(np.float32)
    ).cuda()
    p = tm.cube_to_params_core(u, c)
    args = _args(damped, B, seed=B)
    kw = dict(half=s.half, asymm=s.asymmlike)
    ll = [tm.loglike_from_fused(p, c, s, *f(*args, **kw)).double().cpu().numpy()
          for f in (voigt_cuda.fused_loglike, voigt_cuda.fused_loglike_plain)]
    assert np.array_equal(np.isfinite(ll[0]), np.isfinite(ll[1]))
    fin = np.isfinite(ll[1])
    np.testing.assert_allclose(ll[0][fin], ll[1][fin], rtol=1e-5, atol=0.05)


@pytest.mark.parametrize("B", (100, 13))
def test_tau_kernel_matches_plain(any_fwd, B):
    args = _args(any_fwd, B, seed=2 * B)
    targs = args[:6] + args[11:]
    before = voigt_cuda.tau_launches
    k = voigt_cuda.voigt_tau(*targs)
    assert voigt_cuda.tau_launches == before + 1
    q = voigt_cuda.voigt_tau_plain(*targs)
    torch.cuda.synchronize()
    err = ((k - q).abs() / (q.abs() + 1e-3)).max().item()
    assert err < 3e-5, err


def test_entry_points_launch_the_tau_kernel(any_fwd):
    """reconstruct and chi2 on a card: one tau launch each, the values of
    the plain version on the CPU."""
    s, c = any_fwd.static, any_fwd.consts()
    u = torch.from_numpy(
        np.random.default_rng(4).uniform(0.02, 0.98, (8, s.ndim)).astype(np.float32)
    ).cuda()
    p = tm.cube_to_params_core(u, c)
    before = voigt_cuda.tau_launches
    flux = any_fwd.reconstruct(p)
    chi2 = any_fwd.chi2(p)
    assert voigt_cuda.tau_launches == before + 2
    cpu = tm.TorchForward(s, {k: v.cpu() for k, v in c.items()})
    assert (flux.cpu() - cpu.reconstruct(p.cpu())).abs().max().item() < 1e-5
    np.testing.assert_allclose(
        chi2.cpu().numpy(), cpu.chi2(p.cpu()).numpy(), rtol=1e-5, atol=0.1
    )
