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


@pytest.mark.parametrize("B", (1, 13, 100, 1000, 1003))
def test_tau_kernel_matches_plain(any_fwd, B):
    """Groups of 1, 2 or 4 samples by the geometry's choice; B = 13 and 1003
    leave a partial last group where S > 1."""
    args = _args(any_fwd, B, seed=2 * B)
    targs = args[:6] + args[11:]
    before = voigt_cuda.tau_launches
    k = voigt_cuda.voigt_tau(*targs)
    assert voigt_cuda.tau_launches == before + 1
    q = voigt_cuda.voigt_tau_plain(*targs)
    torch.cuda.synchronize()
    err = ((k - q).abs() / (q.abs() + 1e-3)).max().item()
    assert err < 3e-5, err


def test_tau_kernel_beyond_the_grid_dimension_limit():
    """B = 65,537 samples, more than one grid dimension's 65,535 blocks:
    the first and last rows against the plain version."""
    fwd = _forward("narrow")
    B = 65537
    targs = (lambda a: a[:6] + a[11:])(_args(fwd, B, seed=6))
    k = voigt_cuda.voigt_tau(*targs)
    rows = torch.cat([torch.arange(0, 64), torch.arange(B - 192, B)]).cuda()
    q = voigt_cuda.voigt_tau_plain(*(a[rows] for a in targs[:4]), *targs[4:])
    torch.cuda.synchronize()
    err = ((k[rows] - q).abs() / (q.abs() + 1e-3)).max().item()
    assert err < 3e-5, err


@pytest.mark.parametrize("B", (100, 1003))
def test_tau_repeated_launches_are_bit_identical(any_fwd, B):
    targs = (lambda a: a[:6] + a[11:])(_args(any_fwd, B, seed=8))
    first = voigt_cuda.voigt_tau(*targs)
    for _ in range(3):
        assert torch.equal(voigt_cuda.voigt_tau(*targs), first)


@pytest.mark.parametrize("name,damped", [("flagship", False), ("narrow", True), ("mixed", True)])
def test_tau_instantiation_follows_the_mode_table(name, damped, monkeypatch):
    """The Harris-only kernel for the flagship, the damped one for a model
    with a strongly damped transition, at the geometry tau_geometry gives."""
    fwd = _forward(name)
    seen = []
    launch = voigt_cuda._launch_tau
    monkeypatch.setattr(voigt_cuda, "_launch_tau",
                        lambda *a: seen.append(a[3:5]) or launch(*a))
    targs = (lambda a: a[:6] + a[11:])(_args(fwd, 100, seed=4))
    voigt_cuda.voigt_tau(*targs)
    s = fwd.static
    assert seen == [(damped, voigt_cuda.tau_geometry(100, s.ntrans, s.npix, damped))]


@pytest.mark.parametrize("B", (100, 200, 1000))
def test_tau_occupancy(any_fwd, B):
    """At least the one-sample kernel's 2 CTAs of 256 threads (16 warps)
    stay resident per SM (the CUDA occupancy API)."""
    s = any_fwd.static
    damped = voigt_cuda._any_damped(any_fwd.modes)
    g = voigt_cuda.tau_geometry(B, s.ntrans, s.npix, damped)
    ctas = voigt_cuda.tau_occupancy(damped, g)
    assert ctas >= 2 and ctas * g.threads // 32 >= 16, ctas


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


RAGGED = [(P, half) for P in (1, 23, 255, 257, 2049, 5000) for half in (0, 11) if P > 2 * half]


def _resampled(args, P, half, B, T=None):
    """The model's fused_loglike arguments on a spectrum of P pixels: its d0
    rows, c/lambda, data, ivar and 1/noise linearly resampled, the first B
    samples and T transitions of its line tables; its own taps when half is
    the model's, else one box of 2 half + 1 taps and one continuum shared by
    the batch."""
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, modes = args
    T = T or dz.shape[1]
    x = np.linspace(0.0, cw.shape[0] - 1.0, P)
    grid = np.arange(cw.shape[0], dtype=np.float64)

    def resample(v):
        a = v.double().cpu().numpy()
        out = np.stack([np.interp(x, grid, row) for row in a.reshape(-1, a.shape[-1])])
        return torch.from_numpy(out.reshape(a.shape[:-1] + (P,)).astype(np.float32)).cuda()

    rows = lambda v: v[:B, :T].contiguous()
    if half == (kern.shape[1] - 1) // 2:
        kern, cont = kern[:B].contiguous(), cont[:B].contiguous()
    else:
        kern = torch.full((1, 2 * half + 1), 1.0 / (2 * half + 1), device=kern.device)
        cont = cont[:1].contiguous()
    return (rows(dz), rows(gain), rows(av), rows(dnu), resample(d0[:T]), resample(cw),
            resample(data), resample(ivar), resample(inv_noise), kern, cont,
            tmin[:T].contiguous(), modes[:T].contiguous())


def _check_against_plain(args, half):
    k = voigt_cuda.fused_loglike(*args, half=half, asymm=True)
    q = voigt_cuda.fused_loglike_plain(*args, half=half, asymm=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(k[0].cpu().numpy(), q[0].cpu().numpy(), rtol=1e-5, atol=0.1)
    for a, b in zip(k[1:], q[1:]):
        assert np.max(np.abs(a.cpu().numpy() - b.cpu().numpy()), initial=0.0) <= 1.0


@pytest.mark.parametrize("B", (100, 1))
@pytest.mark.parametrize("P,half", RAGGED)
def test_ragged_spectra_match_plain(any_fwd, P, half, B):
    """Spectra that do not fill whole 256-pixel tiles, a cluster of 1 to 8
    CTAs, with and without the LSF (half = 0), per-sample or shared taps."""
    args = _resampled(_args(any_fwd, 100, seed=P), P, half, B)
    _check_against_plain(args, half)


@pytest.mark.parametrize("B", (100, 1))
def test_long_spectrum_matches_plain(any_fwd, B):
    """65,536 pixels: more than one CTA's shared memory could hold for the
    whole spectrum, so each CTA of the cluster takes a 8,192-pixel tile."""
    args = _resampled(_args(any_fwd, 100, seed=9), 65536, any_fwd.static.half, B, T=2)
    assert voigt_cuda.fused_geometry(2, 65536, any_fwd.static.half).tile == 8192
    _check_against_plain(args, any_fwd.static.half)


@pytest.mark.parametrize("P,half", [(1999, 11), (257, 11), (5000, 0)])
def test_repeated_launches_are_bit_identical(any_fwd, P, half):
    """The chi^2 reduction has a fixed order (no float atomics): two launches
    on the same inputs give the same bits, as the sampler's reproducibility
    at a fixed seed needs."""
    args = _resampled(_args(any_fwd, 100, seed=3), P, half, 100)
    first = voigt_cuda.fused_loglike(*args, half=half, asymm=True)
    for _ in range(3):
        again = voigt_cuda.fused_loglike(*args, half=half, asymm=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_occupancy_at_the_production_batch(any_fwd):
    """B=100 launches at least 132 CTAs, and at least 16 warps stay
    resident per SM (the CUDA occupancy API)."""
    s = any_fwd.static
    g = voigt_cuda.fused_geometry(s.ntrans, s.npix, s.half)
    damped = voigt_cuda.MODE_HJERT in any_fwd.modes.tolist()
    ctas_per_sm, clusters = voigt_cuda.fused_occupancy(s.ntrans, s.npix, s.half, damped)
    assert 100 * g.cluster >= 132
    assert ctas_per_sm * g.threads // 32 >= 16
    assert clusters >= 1


# ---- the problem axis (stacked problems, one launch) ------------------------

def _stacked_pair():
    """Two different problems stacked on the card: the flagship, and its
    model on a shorter range padded to the same 1999 pixels."""
    from mcalf_torch.models.batched import pad_model_to_npix, stack_problems

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    full = AbsorptionModel.from_file(spec, **MODELS["flagship"])
    short = AbsorptionModel.from_file(spec, **dict(MODELS["flagship"], fitrange=[(6182.0, 6216.0)]))
    models = [full, pad_model_to_npix(short, full.npix)]
    s, stacked = stack_problems(models)
    return tm.make_stacked_forward(s, stacked, "cuda"), [make_torch_forward(m, "cuda") for m in models]


@pytest.mark.parametrize("B", (100, 37, 1))
def test_stacked_kernel_matches_plain_and_single_rows(B):
    sf, solo = _stacked_pair()
    s = sf.static
    u = torch.from_numpy(
        np.random.default_rng(B).uniform(0.02, 0.98, (2 * B, s.ndim)).astype(np.float32)
    ).cuda()
    prob = (torch.arange(2 * B, device="cuda") % 2).to(torch.int32)
    c = tm.row_consts(sf.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    p = tm.cube_to_params_core(u, c)
    args = tm.fused_args(p, c, s, dz=dz, prob=prob)
    kw = dict(half=s.half, asymm=True, prob=prob)
    before = voigt_cuda.launches
    k = voigt_cuda.fused_loglike(*args, **kw)
    assert voigt_cuda.launches == before + 1
    q = voigt_cuda.fused_loglike_plain(*args, **kw)
    np.testing.assert_allclose(k[0].cpu().numpy(), q[0].cpu().numpy(), rtol=1e-5, atol=0.1)
    lk = tm.loglike_from_fused(p, c, s, *k).cpu().numpy()
    lq = tm.loglike_from_fused(p, c, s, *q).cpu().numpy()
    assert np.array_equal(np.isfinite(lk), np.isfinite(lq))
    fin = np.isfinite(lk)
    np.testing.assert_allclose(lk[fin], lq[fin], rtol=1e-5, atol=0.05)
    # each row is the single-problem launch's, bit for bit
    for i in range(2):
        rows = prob == i
        one = solo[i].loglike_cube(u[rows])
        assert torch.equal(sf.loglike_cube(u, prob)[rows], one)


def test_stacked_kernel_wrapper_validation():
    sf, _ = _stacked_pair()
    s = sf.static
    u = torch.rand((4, s.ndim), device="cuda")
    prob = torch.tensor([0, 1, 0, 1], device="cuda", dtype=torch.int32)
    c = tm.row_consts(sf.consts(), prob)
    args = tm.fused_args(tm.cube_to_params_core(u, c), c, s, prob=prob)
    kw = dict(half=s.half, asymm=False)
    with pytest.raises(ValueError, match="prob: need a contiguous int32"):
        voigt_cuda.fused_loglike(*args, **kw, prob=prob.long())
    with pytest.raises(ValueError, match=r"prob: shape \(3,\)"):
        voigt_cuda.fused_loglike(*args, **kw, prob=prob[:3].contiguous())
    with pytest.raises(ValueError, match="d0: shape"):
        voigt_cuda.fused_loglike(*args, **kw)  # stacked tables without prob


def _stacked_tau_pair(name):
    """The model ``name`` on the full range and on a shorter one padded to
    its pixels, stacked on the card (the layout and mode tables shared)."""
    from mcalf_torch.models.batched import pad_model_to_npix, stack_problems

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    full = AbsorptionModel.from_file(spec, **MODELS[name])
    short = AbsorptionModel.from_file(spec, **dict(MODELS[name], fitrange=[(6182.0, 6216.0)]))
    s, stacked = stack_problems([full, pad_model_to_npix(short, full.npix)], conv_mode="wrap")
    return tm.make_stacked_forward(s, stacked, "cuda")


def _stacked_tau_args(sf, B, seed):
    """voigt_tau's arguments for B rows of the two problems, interleaved in
    a random order, and their (B,) int32 problems."""
    s = sf.static
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.uniform(0.02, 0.98, (B, s.ndim)).astype(np.float32)).cuda()
    prob = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).cuda()
    c = tm.row_consts(sf.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    args = tm.fused_args(tm.cube_to_params_core(u, c), c, s, dz=dz, prob=prob)
    return args[:6] + args[11:], prob


@pytest.mark.parametrize("B", (1, 13, 100, 1000))
@pytest.mark.parametrize("name", ("flagship", "narrow", "mixed"))
def test_stacked_tau_matches_plain_and_single_problem_launches(name, B):
    """The tau kernel's problem axis, rows of two problems interleaved:
    within the tau bar of the plain version, and every row bit for bit
    the single-problem launch's (groups of S consecutive rows span both
    problems)."""
    sf = _stacked_tau_pair(name)
    targs, prob = _stacked_tau_args(sf, B, seed=B)
    before = voigt_cuda.tau_launches
    k = voigt_cuda.voigt_tau(*targs, prob=prob)
    assert voigt_cuda.tau_launches == before + 1
    q = voigt_cuda.voigt_tau_plain(*targs, prob=prob)
    torch.cuda.synchronize()
    err = ((k - q).abs() / (q.abs() + 1e-3)).max().item()
    assert err < 3e-5, err
    d0, cw = targs[4], targs[5]
    for i in range(2):
        rows = (prob == i).nonzero().squeeze(1)
        if rows.numel() == 0:
            continue
        one = voigt_cuda.voigt_tau(*(a[rows].contiguous() for a in targs[:4]), d0[i], cw[i],
                                   *targs[6:])
        assert torch.equal(k[rows], one)


def test_stacked_tau_wrapper_validation():
    sf = _stacked_tau_pair("flagship")
    targs, prob = _stacked_tau_args(sf, 8, seed=1)
    with pytest.raises(ValueError, match="prob: need a contiguous int32"):
        voigt_cuda.voigt_tau(*targs, prob=prob.long())
    with pytest.raises(ValueError, match=r"prob: shape \(7,\)"):
        voigt_cuda.voigt_tau(*targs, prob=prob[:7].contiguous())
    with pytest.raises(ValueError, match="d0"):
        voigt_cuda.voigt_tau(*targs)  # stacked tables without prob
    with pytest.raises(ValueError, match="d0"):
        voigt_cuda.voigt_tau(*targs[:4], targs[4][0], targs[5][0], *targs[6:], prob=prob)


def test_tau_library_exports_its_abi_version():
    """tools/compare_tau.py calls a library through this checkout's wrapper
    when it exports mcalf_voigt_tau_abi: version 2, the problem axis."""
    from mcalf_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert _build.load().lib.mcalf_voigt_tau_abi() == 2


def test_fleet_member_is_the_solo_fit_on_the_card():
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.parallel import fit_stacked
    from mcalf_torch.sampler import NSConfig, nested_sample
    from mcalf_torch.sampler.nested import unstack_results

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), **dict(_CIV, ncomp=(1, 1), brange=[10.0, 40.0]))
    cfg = NSConfig(ndim=4, nlive=40, num_repeats=4, max_samples=1000)
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (1, 2, 3)]
    before = voigt_cuda.launches
    res = fit_stacked(*stack_problems([model] * 3), cfg, mesh=["cuda"], generators=gens)
    fleet_launches = voigt_cuda.launches - before
    fwd = make_torch_forward(model, "cuda")
    solo_launches = 0
    for s, member in zip((1, 2, 3), unstack_results(res)):
        before = voigt_cuda.launches
        one = nested_sample(fwd.loglike_cube, torch.Generator(device="cuda").manual_seed(s), cfg, "cuda")
        solo_launches = max(solo_launches, voigt_cuda.launches - before)
        assert float(member.logz) == float(one.logz) and member.n_like == one.n_like
        assert torch.equal(member.samples_u, one.samples_u) and torch.equal(member.logl, one.logl)
    # one launch per stacked call: as many as the longest member's own
    assert solo_launches <= fleet_launches < 3 * solo_launches
