"""The flagship CIV fit at MC-ALF's default Doppler prior (b 1-30 km/s,
``benchmark/configs/civ_narrow.cfg``): every transition's mode is the full
damped Voigt function, and the port's plain CPU likelihood matches the
benchmark's float64 reference within the port's bar (0.05 + 1e-5 |log L|)
on rows with and without a line whose damping needs it.  Also the fused
kernel's line counters (``voigt_cuda.lines`` as ``count_launch`` drives
it, ``hjert_lines`` through a stand-in for the card's counter), the wing
thresholds its weakly damped lines take, and what the benchmark pins of
the configuration."""

import configparser
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.physics import Problem
from mcalf_torch.config import readconfig
from mcalf_torch.models import make_torch_forward
from mcalf_torch.ops import voigt_cuda
from mcalf_torch.runner import build_model
from mcalf_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "benchmark" / "configs" / "civ_narrow.cfg"
FLAGSHIP = ROOT / "testdata" / "fit.cfg"
SPECTRUM = ROOT / "testdata" / "civ_mock_spec_multicomp.txt"
#: b (km/s) below which a CIV 1548 line has damping a >= 1e-3
B_DAMPED = 3.26


def _forward(cfg):
    pars = readconfig(str(cfg))
    pars["specfile"] = str(SPECTRUM)
    model = build_model(pars)
    return model, make_torch_forward(model, "cpu")


@pytest.fixture(scope="module")
def narrow():
    model, fwd = _forward(CFG)
    return model, fwd, Problem(str(CFG), str(SPECTRUM.parent))


def _rows(ref, narrow_lines: bool, n: int, seed: int) -> np.ndarray:
    """``n`` unit-cube rows whose active components carry a line with b below
    B_DAMPED (one or two of them), or none below 4 km/s."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, ref.ndim)).astype(np.float32)
    bcols = 1 + 3 * np.arange(ref.ncompmax) + 2
    span = ref.hi[bcols[0]] - ref.lo[bcols[0]]
    floor = (4.0 - ref.lo[bcols[0]]) / span
    u[:, bcols] = floor + (1 - floor) * u[:, bcols]
    if narrow_lines:
        top = (B_DAMPED - ref.lo[bcols[0]]) / span
        for r in range(n):
            k = int(ref.ncomp_active(u[r:r + 1])[0])
            for c in rng.choice(k, size=1 + r % 2, replace=False):
                u[r, bcols[c]] = top * rng.random()
    return u


def _damped_active(ref, u) -> np.ndarray:
    """Per row, the active lines whose damping is at least 1e-3."""
    _, _, a, _, active = ref.line_tables(u)
    return ((a >= 1e-3) & active).sum(axis=1)


def test_every_transition_takes_the_damped_voigt_function(narrow):
    model, fwd, ref = narrow
    assert fwd.static.ntrans == 22
    assert fwd.modes.tolist() == [voigt_cuda.MODE_HJERT] * 22
    np.testing.assert_array_equal(ref.lo, model.bounds_lo)
    np.testing.assert_array_equal(ref.hi, model.bounds_hi)
    assert (ref.lo[3::3][:11] == 1.0).all() and (ref.hi[3::3][:11] == 30.0).all()
    assert ref.half == model.kernel_half_size() and ref.npix == model.npix == 1999


@pytest.mark.parametrize("rows", ("seeded", "narrow_lines", "no_narrow_line"))
def test_plain_likelihood_matches_the_reference(narrow, rows):
    _, fwd, ref = narrow
    if rows == "seeded":
        u = np.random.default_rng(7).random((16, ref.ndim)).astype(np.float32)
    else:
        u = _rows(ref, rows == "narrow_lines", 8, seed=len(rows))
        damped = _damped_active(ref, u)
        assert (damped > 0).all() if rows == "narrow_lines" else (damped == 0).all()
    got = fwd.loglike_cube(torch.from_numpy(u)).numpy().astype(np.float64)
    want = ref.loglike(u)
    assert np.isfinite(want).all()
    assert np.all(np.abs(got - want) <= 0.05 + 1e-5 * np.abs(want)), np.abs(got - want).max()


def test_the_configuration_is_the_flagship_with_the_default_prior():
    """civ_narrow.cfg is testdata/fit.cfg with brange 1, 30 (readconfig's
    default), and the benchmark's configuration pins its bytes and the
    spectrum's; the copy of the spectrum beside the .cfg is the same file."""
    got, want = configparser.ConfigParser(), configparser.ConfigParser()
    got.read(CFG)
    want.read(FLAGSHIP)
    assert got.get("components", "brange") == "1.0, 30.0"
    got.set("components", "brange", want.get("components", "brange"))
    assert {s: dict(got[s]) for s in got.sections()} == {s: dict(want[s]) for s in want.sections()}
    pinned = json.loads((CFG.with_suffix(".json")).read_text())
    sha = {p: hashlib.sha256((ROOT / p).read_bytes()).hexdigest()
           for p in (pinned["cfg"], pinned["spectrum"])}
    assert sha == {pinned["cfg"]: pinned["cfg_sha256"],
                   pinned["spectrum"]: pinned["spectrum_sha256"]}
    assert (CFG.parent / SPECTRUM.name).read_bytes() == SPECTRUM.read_bytes()
    assert not [k for k in pinned["changes"] if k.startswith("components.")]


def _count(modes, rows, captured_replays, monkeypatch):
    """The host counters' change for one cube launch of ``rows`` rows on the
    mode table ``modes``, counted as the wrapper counts it: at once, or
    captured and then replayed ``captured_replays`` times."""
    before = voigt_cuda.launches, voigt_cuda.cube_launches, voigt_cuda.lines
    add = voigt_cuda._fused_counter(True, rows, int(modes.numel()))
    capturing = [bool(captured_replays)]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    if not captured_replays:
        profiling.count_launch(add)
    else:
        with profiling.captured_launches() as replayed:
            profiling.count_launch(add)
            capturing[0] = False
        for _ in range(captured_replays):
            replayed()
    after = voigt_cuda.launches, voigt_cuda.cube_launches, voigt_cuda.lines
    return tuple(a - b for a, b in zip(after, before))


@pytest.fixture
def card(monkeypatch):
    """A stand-in for the cards' ``hjert_lines`` counters: device index ->
    the mode-2 lines its kernels counted; no device has run a damped fused
    launch yet."""
    counts = {}
    monkeypatch.setattr(voigt_cuda, "_HJERT_DEVICES", set())
    monkeypatch.setattr(voigt_cuda, "_device_counter", lambda _name, i: counts[i])
    return counts


@pytest.mark.parametrize("replays", (0, 3))
def test_line_counters_per_mode_table(narrow, replays, monkeypatch, card):
    """Either table counts B x 22 lines a launch on the host, a captured
    launch at each replay; ``hjert_lines`` is what the card counted, read
    from each device that ran a damped launch (the narrow table's), never
    from one that ran the flagship's Harris-only instantiation."""
    _, fwd, _ = narrow
    _, flagship = _forward(FLAGSHIP)
    assert voigt_cuda._hjert_count(fwd.modes) == 22
    assert voigt_cuda._hjert_count(flagship.modes) == 0
    n = max(replays, 1)
    assert _count(fwd.modes, 800, replays, monkeypatch) == (n, n, n * 800 * 22)
    assert _count(flagship.modes, 100, replays, monkeypatch) == (n, n, n * 100 * 22)
    # one counter per launch shape: a replay makes one call for each
    assert voigt_cuda._fused_counter(True, 800, 22) is voigt_cuda._fused_counter(True, 800, 22)
    card.update({0: n * 800 * 3, 1: 7})
    assert voigt_cuda.hjert_lines == 0  # no damped launch: no device is read
    voigt_cuda._counted(torch.device("cuda", 1), voigt_cuda._any_damped(flagship.modes))
    assert voigt_cuda.hjert_lines == 0
    voigt_cuda._counted(torch.device("cuda", 0), voigt_cuda._any_damped(fwd.modes))
    assert voigt_cuda.hjert_lines == n * 800 * 3
    card[0] += 800 * 2  # the card's next launch
    assert voigt_cuda.hjert_lines == (n + 1) * 800 * 3 - 800


def test_the_table_entry_counts_no_cube_launch(monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    before = voigt_cuda.launches, voigt_cuda.cube_launches, voigt_cuda.lines
    profiling.count_launch(voigt_cuda._fused_counter(False, 5, 22))
    assert (voigt_cuda.launches, voigt_cuda.cube_launches, voigt_cuda.lines) == (
        before[0] + 1, before[1], before[2] + 110)
    card[0] = 10
    voigt_cuda._counted(torch.device("cuda", 0), True)
    assert voigt_cuda.hjert_lines == 10


@pytest.mark.parametrize("window", ("1", "0"))
def test_the_tmin_table_carries_the_damped_transitions_wing_threshold(window, monkeypatch):
    """The narrow model's transitions are all MODE_HJERT, so ``win_tmin``
    (held equal to the JAX package's) stays 0, and the kernels' ``tmin``
    carries the wing threshold max(HJERT_WIN_TMIN, ln(amp_max 1e8)) that a
    line given the Harris expansion takes, by the bound the Harris
    transitions' thresholds use; 0 (plain Harris) with the window off.  The
    flagship's table is its ``win_tmin`` as before."""
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.ops.faddeeva import HJERT_WIN_TMIN

    monkeypatch.setenv("MCALF_TORCH_WINDOW", window)
    model, fwd = _forward(CFG)
    s = fwd.static
    assert s.win_tmin == (0.0,) * 22 and tm.line_modes(s) == (voigt_cuda.MODE_HJERT,) * 22
    tab = model.transition_table()
    dnu_min = model.bounds_lo[tab["pidx"] + 2] * 1e5 * (1e8 / tab["wrest"])
    amp_max = tm.TAU_CONST * 10.0 ** model.bounds_hi[tab["pidx"]] * tab["f"] / dnu_min
    want = np.maximum(HJERT_WIN_TMIN, np.log(amp_max * 1e8)) if window == "1" else np.zeros(22)
    # from the float32 prior box and line constants the forward model holds
    np.testing.assert_allclose(fwd.tmin.double().numpy(), want, rtol=1e-6)
    if window == "1":
        assert (fwd.tmin > HJERT_WIN_TMIN).all()
    _, flagship = _forward(FLAGSHIP)
    assert flagship.tmin.tolist() == [float(np.float32(v)) for v in flagship.static.win_tmin]


# ---- on a card: the fused kernel's per-line choice of Harris or hjert -------

ROW_KINDS = ("seeded", "narrow_lines", "no_narrow_line")


@pytest.fixture(scope="module")
def narrow_cuda(narrow):
    """The narrow model on the card, solo and as the benchmark's fleet
    stacks it (8 problems of the same model), and per kind of rows 800 rows
    with the reference's log L."""
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.models.batched import stack_problems

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, _, ref = narrow
    fwd = make_torch_forward(model, "cuda")
    stacked = tm.make_stacked_forward(*stack_problems([model] * 8), "cuda")
    rows = {}
    for kind in ROW_KINDS:
        if kind == "seeded":
            u = np.random.default_rng(11).random((800, ref.ndim)).astype(np.float32)
        else:
            u = _rows(ref, kind == "narrow_lines", 800, seed=len(kind))
        rows[kind] = (u, ref.loglike(u))
    return fwd, stacked, rows


def _on_card(narrow_cuda, kind, layout):
    """(forward, cube rows on the card, prob or None, reference log L)."""
    fwd, stacked, rows = narrow_cuda
    u, want = rows[kind]
    if layout == "solo":
        return fwd, torch.from_numpy(u[:100]).cuda(), None, want[:100]
    prob = torch.arange(8, device="cuda", dtype=torch.int32).repeat_interleave(100)
    return stacked, torch.from_numpy(u).cuda(), prob, want


def _cube(f, u, prob):
    return f.loglike_cube(u) if prob is None else f.loglike_cube(u, prob)


def _table_entry(f, u, prob):
    """log L through the (B, T) table entry (fused_loglike) and its glue."""
    from mcalf_torch.models import torch_model as tm

    c = f.consts() if prob is None else tm.row_consts(f.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    return tm.loglike_core(tm.cube_to_params_core(u, c), c, f.static, dz=dz, prob=prob)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("solo", "stacked"))
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_kernel_matches_the_reference_on_narrow_rows(narrow_cuda, kind, layout):
    """The damped cube kernel, each MODE_HJERT line in the regime its own
    damping gives it, within the port's bar of the float64 reference
    (scipy's wofz on every line); the -inf pattern exact."""
    f, u, prob, want = _on_card(narrow_cuda, kind, layout)
    got = _cube(f, u, prob).double().cpu().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    assert np.all(err <= 0.05 + 1e-5 * np.abs(want[fin])), err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("solo", "stacked"))
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_cube_entry_is_the_table_entry_on_narrow_rows(narrow_cuda, kind, layout):
    """Both entries choose each line's regime by the same rule, so the cube
    entry's log L is the table entry's bit for bit."""
    f, u, prob, _ = _on_card(narrow_cuda, kind, layout)
    assert torch.equal(_cube(f, u, prob), _table_entry(f, u, prob))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("solo", "stacked"))
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_kernel_matches_the_plain_twin_on_narrow_rows(narrow_cuda, kind, layout):
    """Against the plain version (Algorithm 916 on every line of a
    MODE_HJERT transition) on the same tables: rtol 1e-5, atol 0.05."""
    from mcalf_torch.models import torch_model as tm

    f, u, prob, _ = _on_card(narrow_cuda, kind, layout)
    got = _cube(f, u, prob).double().cpu().numpy()
    t = tm.cube_tables(f.consts(), f.static)
    want = voigt_cuda.fused_loglike_cube_plain(
        u, prob, t, half=f.static.half, asymm=f.static.asymmlike).double().cpu().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0.05)


def _series_pairs(f, u, prob) -> tuple[int, int]:
    """The (line, pixel) pairs the fused kernel gives the Algorithm 916
    series: the pixels with u^2 + a^2 < R2_SWITCH of each active MODE_HJERT
    line whose float32 damping reaches HARRIS_A_MAX, from the glue's own
    (B, T) tables and u as the plain twin forms it (d0 + dz c/lambda
    rounded once, times 1/dnu).  The kernel forms u^2 + a^2 in float32, with
    whichever contraction nvcc chose, so a pair within two float32 ulps of
    R2_SWITCH may fall either side: returns (sure, possible), the count of
    the pairs inside the radius less that band and with it."""
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.ops.faddeeva import HARRIS_A_MAX, R2_SWITCH

    c = f.consts() if prob is None else tm.row_consts(f.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    args = tm.fused_args(tm.cube_to_params_core(u, c), c, f.static, dz=dz)
    dz, gain, av, dnu, d0, cw = (x.cpu() for x in args[:6])
    T, P = d0.shape[-2:]
    d0, cw = d0.reshape(-1, T, P), cw.reshape(-1, P)
    hjert = (f.modes.cpu() == voigt_cuda.MODE_HJERT)[None, :]
    b, t = (hjert & (av >= torch.tensor(HARRIS_A_MAX)) & (gain != 0)).nonzero(as_tuple=True)
    q = torch.zeros_like(b) if prob is None else prob.cpu().long()[b]
    s = (d0[q, t].double() + dz[b, t, None].double() * cw[q].double()).float()
    x = (s * (1.0 / dnu[b, t])[:, None]).double()
    a = av[b, t, None].double()
    r2 = x * x + a * a  # exact: u and a are float32
    band = 2 * np.spacing(np.float32(R2_SWITCH))
    return int((r2 < R2_SWITCH - band).sum()), int((r2 < R2_SWITCH + band).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("solo", "stacked"))
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_series_evals_counts_the_pairs_that_take_the_series(narrow_cuda, kind, layout):
    """``series_evals`` adds, per damped launch, the (line, pixel) pairs of
    its mode-2 lines inside the 916 series' radius, counted on the host from
    the same tables (none on rows without a damped line), and a captured
    launch adds them at each replay and nothing while captured."""
    f, u, prob, _ = _on_card(narrow_cuda, kind, layout)
    sure, possible = _series_pairs(f, u, prob)
    assert (possible == 0) if kind == "no_narrow_line" else (sure > 0)
    before = voigt_cuda.series_evals
    _cube(f, u, prob)
    want = voigt_cuda.series_evals - before
    assert sure <= want <= possible
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _cube(f, u, prob)  # warm-up on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    before = voigt_cuda.series_evals
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _cube(f, u, prob)
    assert voigt_cuda.series_evals == before
    for n in (1, 2):
        g.replay()
        assert voigt_cuda.series_evals == before + n * want
