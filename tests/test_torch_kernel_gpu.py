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
    # the flagship as testdata/fit.cfg has it (no asymmetric likelihood)
    "flagship_symm": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0]),
    # brange = 3, 40: all 22 transitions strongly damped (full hjert)
    "narrow": dict(_CIV, ncomp=(8, 11), brange=[3.0, 40.0], Asymmlike=True),
    # benchmark/configs/civ_narrow.cfg: MC-ALF's default brange = 1, 30, all
    # 22 transitions strongly damped, no asymmetric likelihood
    "civ_narrow": dict(_CIV, ncomp=(8, 11), brange=[1.0, 30.0]),
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


# ---- the wing window switched off: mode 0 (plain Harris) on every pixel ----

def _window_pair(name):
    """A model of all-Harris transitions with MCALF_TORCH_WINDOW=0: every
    transition in MODE_HARRIS, the counterpart of the plain-Harris branch
    of the JAX package's _ll_kernel and _tau_kernel.  Beside it the same
    model with the window on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCALF_TORCH_WINDOW", "0")
        off = _forward(name)
    on = _forward(name)
    assert off.modes.tolist() == [voigt_cuda.MODE_HARRIS] * off.static.ntrans
    assert set(on.modes.tolist()) == {voigt_cuda.MODE_WINDOWED}
    return off, on


@pytest.fixture(scope="module")
def window_off():
    return _window_pair("flagship")


@pytest.mark.parametrize("B", (100, 37, 1))
def test_window_off_kernel_matches_plain(window_off, B):
    fwd = window_off[0]
    s, c = fwd.static, fwd.consts()
    args = _args(fwd, B, seed=B + 11)
    u = torch.from_numpy(
        np.random.default_rng(B + 11).uniform(0.02, 0.98, (B, s.ndim)).astype(np.float32)
    ).cuda()
    p = tm.cube_to_params_core(u, c)
    kw = dict(half=s.half, asymm=s.asymmlike)
    before = voigt_cuda.launches
    k = voigt_cuda.fused_loglike(*args, **kw)
    assert voigt_cuda.launches == before + 1
    q = voigt_cuda.fused_loglike_plain(*args, **kw)
    np.testing.assert_allclose(k[0].cpu().numpy(), q[0].cpu().numpy(), rtol=1e-5, atol=0.1)
    ll = [tm.loglike_from_fused(p, c, s, *x).double().cpu().numpy() for x in (k, q)]
    assert np.array_equal(np.isfinite(ll[0]), np.isfinite(ll[1]))
    fin = np.isfinite(ll[1])
    np.testing.assert_allclose(ll[0][fin], ll[1][fin], rtol=1e-5, atol=0.05)


@pytest.mark.parametrize("B", (100, 1000))
def test_window_off_tau_matches_plain(window_off, B):
    targs = (lambda a: a[:6] + a[11:])(_args(window_off[0], B, seed=3 * B))
    before = voigt_cuda.tau_launches
    k = voigt_cuda.voigt_tau(*targs)
    assert voigt_cuda.tau_launches == before + 1
    q = voigt_cuda.voigt_tau_plain(*targs)
    err = ((k - q).abs() / (q.abs() + 1e-3)).max().item()
    assert err < 3e-5, err


def test_window_off_likelihood_matches_window_on():
    """The twin of tests/test_windowing.py::test_windowed_matches_unwindowed_likelihood
    on the card, on its flagship (no asymmetric likelihood): switching the
    window off moves log L by less than 3e-6 relative."""
    off, on = _window_pair("flagship_symm")
    u = torch.from_numpy(
        np.random.default_rng(9).uniform(0.02, 0.98, (64, off.ndim)).astype(np.float32)
    ).cuda()
    l0 = off.loglike_cube(u).double().cpu().numpy()
    lw = on.loglike_cube(u).double().cpu().numpy()
    assert np.isfinite(l0).all() and np.isfinite(lw).all()
    assert np.max(np.abs(lw - l0) / (np.abs(l0) + 1.0)) < 3e-6


# ---- the unit-cube entry: one launch per likelihood call --------------------

def _table_path(fwd, u, prob=None):
    """log L by the (B, T) tables the PyTorch glue makes around
    fused_loglike: the sampler's path before the cube entry."""
    s, c = fwd.static, fwd.consts()
    if prob is not None:
        c = tm.row_consts(c, prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    return tm.loglike_core(tm.cube_to_params_core(u, c), c, s, dz=dz, prob=prob)


def _cube_rows(ndim, B, seed):
    """B unit-cube rows, four of them on the cube's faces."""
    u = np.random.default_rng(seed).uniform(0.02, 0.98, (B, ndim)).astype(np.float32)
    u[0], u[1] = 0.0, 1.0
    u[2, ::2] = 0.0
    u[3, 1::2] = 1.0
    return torch.from_numpy(u).cuda()


def _stacked_flagship(name="flagship_symm", Q=8):
    """Q problems stacked as the fleet stacks them: the flagship and its
    model on a shorter range padded to the same pixels, in turn."""
    from mcalf_torch.models.batched import pad_model_to_npix, stack_problems

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    full = AbsorptionModel.from_file(spec, **MODELS[name])
    short = AbsorptionModel.from_file(spec, **dict(MODELS[name], fitrange=[(6182.0, 6216.0)]))
    models = [full, pad_model_to_npix(short, full.npix)] * (Q // 2)
    return tm.make_stacked_forward(*stack_problems(models), "cuda")


@pytest.mark.parametrize("name", ("flagship_symm", "flagship", "civ_narrow"))
def test_cube_entry_is_the_table_path_on_stacked_rows(name):
    """Q = 8 problems x B = 100 rows in one launch, as the flagship's fleet
    calls it: log L bit for bit the table path's, one launch counted."""
    sf = _stacked_flagship(name)
    s = sf.static
    u = _cube_rows(s.ndim, 800, seed=17)
    prob = torch.arange(8, device="cuda", dtype=torch.int32).repeat_interleave(100)
    want = _table_path(sf, u, prob)
    before = voigt_cuda.launches, voigt_cuda.cube_launches
    got = sf.loglike_cube(u, prob)
    assert (voigt_cuda.launches, voigt_cuda.cube_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    if not s.asymmlike:
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("B", (100, 37, 1))
def test_cube_entry_is_the_table_path_on_solo_rows(any_fwd, B):
    """A solo forward (no problem axis): flagship, narrow and mixed, the
    Harris and the damped instantiations, bit for bit."""
    u = _cube_rows(any_fwd.static.ndim, max(B, 4), seed=B)[:B].contiguous()
    want = _table_path(any_fwd, u)
    before = voigt_cuda.cube_launches
    got = any_fwd.loglike_cube(u)
    assert voigt_cuda.cube_launches == before + 1
    assert torch.equal(got, want)


def _free_forward():
    """The flagship with a free resolution and continuum, the asymmetric
    likelihood and Gaussian priors on its first component."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"),
        **dict(MODELS["flagship"], specres=[6.0, 10.0], contval=[0.9, 1.1]))
    m.gpriors = ["8.0", "1.0"] + ["none"] * (2 * m.ndim - 2)
    m.gpriors[6:12] = ["13.6", "0.5", "2.999", "0.001", "17.5", "5.0"]
    return m, make_torch_forward(m, "cuda", gpriors=True)


def test_cube_entry_with_a_free_resolution_continuum_and_gaussian_priors():
    """The taps built in the prologue (their sum in tap order, PyTorch's in
    another) and the Gaussian priors' sum (column order against PyTorch's
    reduction): log L within rtol 1e-5 / atol 0.05 of the table path, the
    -inf pattern exact; rows near the mock truth, so that the asymmetric
    likelihood accepts some."""
    m, fwd = _free_forward()
    s = fwd.static
    assert s.freespecres and s.freecont and s.asymmlike and s.has_gpriors
    p = [8.0, 1.0, 10.5]
    for N, z, b in zip([13.6, 13.0, 13.8, 13.6, 13.2, 13.4, 13.5, 14.0, 14.2, 13.7],
                       [2.999, 2.9995, 3.0, 3.001, 3.0005, 3.0015, 3.002, 3.0025, 3.0035, 3.0039],
                       [17.5, 10.5, 20.0, 25.0, 15.0, 30.0, 10.0, 25.0, 15.0, 20.0]):
        p += [N, z, b]
    p += [13.0, 3.0, 20.0]
    u0 = (np.array(p) - m.bounds_lo) / (m.bounds_hi - m.bounds_lo)
    rng = np.random.default_rng(1)
    u = np.clip(u0[None] + rng.normal(0, 5e-4, (96, m.ndim)), 1e-4, 1 - 1e-4)
    u = np.concatenate([u, rng.uniform(0.05, 0.95, (32, m.ndim))]).astype(np.float32)
    u = torch.from_numpy(u).cuda()
    got = fwd.loglike_cube(u).double().cpu().numpy()
    want = _table_path(fwd, u).double().cpu().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin[:96].sum() > 40
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0.05)


def test_cube_entry_repeated_launches_are_bit_identical():
    sf = _stacked_flagship()
    u = _cube_rows(sf.static.ndim, 800, seed=5)
    prob = torch.arange(8, device="cuda", dtype=torch.int32).repeat_interleave(100)
    first = sf.loglike_cube(u, prob)
    for _ in range(3):
        assert torch.equal(sf.loglike_cube(u, prob), first)


def test_cube_launches_count_at_each_replay_of_a_captured_graph():
    """Inside a captured graph each likelihood call adds one to ``launches``
    and to ``cube_launches`` at each replay, and nothing while captured; the
    replays' log L is the eager call's."""
    from mcalf_torch.utils.profiling import captured_launches

    sf = _stacked_flagship()
    u = _cube_rows(sf.static.ndim, 800, seed=6)
    prob = torch.arange(8, device="cuda", dtype=torch.int32).repeat_interleave(100)
    want = sf.loglike_cube(u, prob)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sf.loglike_cube(u, prob)  # warm-up on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = voigt_cuda.launches, voigt_cuda.cube_launches
    with captured_launches() as replayed:
        with torch.cuda.graph(g):
            out = sf.loglike_cube(u, prob)
    assert (voigt_cuda.launches, voigt_cuda.cube_launches) == before
    for n in (1, 2, 3):
        g.replay()
        replayed()
        assert voigt_cuda.launches == before[0] + n
        assert voigt_cuda.cube_launches == before[1] + n
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _damped_lines(f, u, prob):
    """The (row, transition) pairs of a MODE_HJERT transition whose float32
    damping reaches HARRIS_A_MAX with a nonzero gain, from the glue's own
    (B, T) tables: the lines the fused kernel gives the full hjert."""
    from mcalf_torch.ops.faddeeva import HARRIS_A_MAX

    c = tm.row_consts(f.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    _, gain, av = tm.fused_args(tm.cube_to_params_core(u, c), c, f.static, dz=dz)[:3]
    hjert = (f.modes == voigt_cuda.MODE_HJERT)[None, :]
    limit = torch.tensor(HARRIS_A_MAX, dtype=torch.float32, device=av.device)
    return int((hjert & (av >= limit) & (gain != 0)).sum())


@pytest.mark.parametrize("name", ("civ_narrow", "flagship_symm"))
def test_line_counters_count_at_each_replay_of_a_captured_graph(name):
    """The narrow fleet's stacked call (8 x 100 rows, every transition
    MODE_HJERT): one launch, then a capture replayed 3 times, each adds 800
    x 22 to ``lines`` and, counted by the card, its strongly damped active
    lines to ``hjert_lines`` (a few percent of the pairs); the flagship's
    adds none to ``hjert_lines``."""
    from mcalf_torch.utils.profiling import captured_launches

    sf = _stacked_flagship(name)
    u = _cube_rows(sf.static.ndim, 800, seed=7)
    prob = torch.arange(8, device="cuda", dtype=torch.int32).repeat_interleave(100)
    damped = _damped_lines(sf, u, prob)
    if name == "civ_narrow":
        assert voigt_cuda._hjert_count(sf.modes) == 22 and 0 < damped < 800 * 22 // 4
    else:
        assert voigt_cuda._hjert_count(sf.modes) == 0 and damped == 0
    before = voigt_cuda.lines, voigt_cuda.hjert_lines
    sf.loglike_cube(u, prob)
    assert (voigt_cuda.lines, voigt_cuda.hjert_lines) == (before[0] + 800 * 22,
                                                          before[1] + damped)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sf.loglike_cube(u, prob)  # warm-up on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = voigt_cuda.lines, voigt_cuda.hjert_lines
    with captured_launches() as replayed:
        with torch.cuda.graph(g):
            sf.loglike_cube(u, prob)
    assert (voigt_cuda.lines, voigt_cuda.hjert_lines) == before
    for n in (1, 2, 3):
        g.replay()
        replayed()
        assert voigt_cuda.lines == before[0] + n * 800 * 22
        assert voigt_cuda.hjert_lines == before[1] + n * damped
    torch.cuda.synchronize()


def test_cube_instantiations_keep_the_occupancy(any_fwd):
    """The cube instantiations keep the table ones' CTAs per SM and
    clusters on the card: 5 CTAs per SM, Harris-only and damped alike."""
    s = any_fwd.static
    damped = voigt_cuda._any_damped(any_fwd.modes)
    table = voigt_cuda.fused_occupancy(s.ntrans, s.npix, s.half, damped)
    cube = voigt_cuda.fused_occupancy(s.ntrans, s.npix, s.half, damped, cube=True)
    assert cube == table and cube[0] == 5


def _ptxas_counts(entry=None):
    """{(damped, cube): (registers, spill store bytes, spill load bytes)} of
    the fused kernel's four instantiations, from ptxas's output in the build
    log: the entry's "Used ... registers", and the spills of the entry and
    of every function ptxas lists under it (an out-of-line callee, such as
    the free-resolution taps, spills in a frame of its own).  Given
    ``entry``, a pattern with one group, the same of the entries it matches,
    keyed by (that group,)."""
    import re

    from mcalf_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out, key = {}, None
    for line in _build.load().log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            if entry is not None:
                k = re.search(entry, m.group(1))
                key = (k.group(1),) if k else None
            else:
                k = re.search(r"fused_loglike_kernelILb([01])ELb([01])E", m.group(1))
                key = (k.group(1) == "1", k.group(2) == "1") if k else None
            if key is not None:
                out[key] = [0, 0, 0]
            continue
        if key is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[key][1] += int(m.group(1))
            out[key][2] += int(m.group(2))
    return {k: tuple(v) for k, v in out.items()}


def test_cube_instantiations_use_no_more_registers_or_spills():
    """ptxas's counts: each cube instantiation within its table twin's
    registers and spilled bytes, its called functions' spills included."""
    counts = _ptxas_counts()
    assert set(counts) == {(d, c) for d in (False, True) for c in (False, True)}, counts
    for damped in (False, True):
        regs, spills = counts[(damped, True)][:2]
        assert regs <= counts[(damped, False)][0] and spills <= counts[(damped, False)][1], counts


def test_register_and_spill_budgets():
    """ptxas's counts: the damped instantiations in the Harris-only ones'
    48 registers (5 CTAs per SM), with no spill in the entry, whose pixel
    loop it is, nor in the frame of the Algorithm 916 series it calls; the
    slice kernels (csrc/slice_step.cu) in at most 64 registers
    (slice_propose's CTA of up to 1,024 threads needs no more) with no
    spill."""
    counts = _ptxas_counts()
    for cube in (False, True):
        assert counts[(True, cube)] == (48, 0, 0), counts
    slices = _ptxas_counts(r"(slice_propose|slice_update)_kernel")
    assert set(slices) == {("slice_propose",), ("slice_update",)}, slices
    for regs, stores, loads in slices.values():
        assert regs <= 64 and stores == loads == 0, slices


def test_harris_instantiations_keep_their_registers():
    """ptxas's counts of the Harris-only instantiations, which never reach
    the Algorithm 916 call: 48 registers and no spill (5 CTAs per SM; the
    per-line test of mode 2 is compiled out of them)."""
    counts = _ptxas_counts()
    for cube in (False, True):
        assert counts[(False, cube)] == (48, 0, 0), counts
