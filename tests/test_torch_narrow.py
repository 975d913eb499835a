"""The flagship CIV fit at MC-ALF's default Doppler prior (b 1-30 km/s,
``benchmark/configs/civ_narrow.cfg``): every transition takes the full
damped Voigt function, and the port's plain CPU likelihood matches the
benchmark's float64 reference within the port's bar (0.05 + 1e-5 |log L|)
on rows with and without a line whose damping needs it.  Also the fused
kernel's line counters (``voigt_cuda.lines``, ``hjert_lines``) as
``count_launch`` drives them, and what the benchmark pins of the
configuration."""

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
    """The counters' change for one cube launch of ``rows`` rows on the mode
    table ``modes``, counted as the wrapper counts it: at once, or captured
    and then replayed ``captured_replays`` times."""
    before = (voigt_cuda.launches, voigt_cuda.cube_launches, voigt_cuda.lines,
              voigt_cuda.hjert_lines)
    add = voigt_cuda._fused_counter(True, rows, int(modes.numel()), voigt_cuda._hjert_count(modes))
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
    after = (voigt_cuda.launches, voigt_cuda.cube_launches, voigt_cuda.lines,
             voigt_cuda.hjert_lines)
    return tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("replays", (0, 3))
def test_line_counters_per_mode_table(narrow, replays, monkeypatch):
    """A damped table counts B x 22 lines and as many hjert lines; the
    flagship's windowed-Harris table B x 22 lines and no hjert line; a
    captured launch counts at each replay."""
    _, fwd, _ = narrow
    _, flagship = _forward(FLAGSHIP)
    assert voigt_cuda._hjert_count(fwd.modes) == 22
    assert voigt_cuda._hjert_count(flagship.modes) == 0
    n = max(replays, 1)
    assert _count(fwd.modes, 800, replays, monkeypatch) == (n, n, n * 800 * 22, n * 800 * 22)
    assert _count(flagship.modes, 100, replays, monkeypatch) == (n, n, n * 100 * 22, 0)
    # one counter per launch shape: a replay makes one call for each
    assert voigt_cuda._fused_counter(True, 800, 22, 22) is voigt_cuda._fused_counter(True, 800, 22, 22)


def test_the_table_entry_counts_no_cube_launch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    before = voigt_cuda.cube_launches, voigt_cuda.lines, voigt_cuda.hjert_lines
    profiling.count_launch(voigt_cuda._fused_counter(False, 5, 22, 2))
    assert (voigt_cuda.cube_launches, voigt_cuda.lines, voigt_cuda.hjert_lines) == (
        before[0], before[1] + 110, before[2] + 10)
