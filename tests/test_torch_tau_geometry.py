"""The tau kernel's launch geometry (``voigt_cuda.tau_geometry``), on the
CPU: how the (B, P) output is laid over CTAs, each one pixel tile of one
group of S samples, and a plain emulation of the kernel's sample-group
dataflow held against ``voigt_tau_plain``.  Also which instantiation the
host picks from the mode table.  Nothing here needs a card: the CUDA
source's constants are read as text.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.ops import voigt_cuda

CSRC = Path(voigt_cuda.__file__).resolve().parents[1] / "csrc"
TESTDATA = Path(__file__).parents[1] / "testdata"

BATCHES = (0, 1, 3, 100, 1000, 65537)
#: test_torch_geometry.py's ragged and long spectra
RAGGED_P = (1, 23, 255, 256, 257, 600, 2048, 2049, 5000)
LONG_P = (65536, 200000, 0)
#: CUDA's limit on gridDim.x and a Hopper CTA's shared memory (bytes)
GRID_X_MAX = 2**31 - 1
SMEM_LIMIT = 232448

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    specres=[8.0], Nrange=[12.0, 14.5], zrange=[2.99, 3.01],
)
MODELS = {
    # testdata/fit.cfg: 22 transitions, all windowed Harris
    "flagship": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0]),
    # brange = 3, 40: all 22 transitions strongly damped (full hjert)
    "narrow": dict(_CIV, ncomp=(8, 11), brange=[3.0, 40.0]),
    # CIV 1548 + HI 1215 + filler: windowed Harris and full hjert
    "mixed": dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
        brange=[5.0, 40.0], zrange=[2.99, 3.01],
    ),
}


def _source_constant(name: str, path: Path) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", path.read_text())
    assert m, f"{name} not in {path}"
    return m.group(1).strip()


def test_constants_match_the_cuda_source():
    cu = CSRC / "voigt_tau.cu"
    assert int(_source_constant("kMaxThreads", cu)) == voigt_cuda.TAU_MAX_THREADS
    assert int(_source_constant("kHarrisMaxSamples", cu)) == voigt_cuda.TAU_MAX_SAMPLES[False]
    assert int(_source_constant("kDampedMaxSamples", cu)) == voigt_cuda.TAU_MAX_SAMPLES[True]
    # the launch bounds: 64 and 80 registers for CTAs of kMaxThreads
    assert "__launch_bounds__(kMaxThreads, kDamped ? kDampedMinCtas : kHarrisMinCtas)" in cu.read_text()
    assert 65536 // (256 * int(_source_constant("kHarrisMinCtas", cu))) == 64
    assert 65536 // (256 * int(_source_constant("kDampedMinCtas", cu))) // 8 * 8 == 80
    for threads in voigt_cuda.TAU_THREADS.values():
        assert 32 <= threads <= voigt_cuda.TAU_MAX_THREADS and threads % 32 == 0


def _block(g, cta, B, P):
    """The (samples, pixels) ranges CTA ``cta`` computes, as
    csrc/voigt_tau.cu's voigt_tau_kernel indexes them."""
    i, j = divmod(cta, g.ntiles)
    S, n = g.samples, g.tile
    return range(i * S, min(i * S + S, B)), range(j * n, min(j * n + n, P))


def _partitions(g, B, P):
    """The sample groups and the pixel tiles, from the CTAs that start each
    group and the CTAs of group 0."""
    groups = [_block(g, i * g.ntiles, B, P)[0] for i in range(-(-B // g.samples))]
    tiles = [_block(g, j, B, P)[1] for j in range(g.ntiles)]
    return groups, tiles


@pytest.mark.parametrize("damped", (False, True))
@pytest.mark.parametrize("P", RAGGED_P + LONG_P)
@pytest.mark.parametrize("B", BATCHES)
def test_every_sample_and_pixel_has_one_cta(B, P, damped):
    """Sample groups partition [0, B) and pixel tiles [0, P); CTA i is the
    pair (group i // ntiles, tile i % ntiles), so the grid writes every
    (sample, pixel) exactly once.  The C entry point's own check of the
    geometry holds too."""
    g = voigt_cuda.tau_geometry(B, 22, P, damped)
    assert 1 <= g.samples <= voigt_cuda.TAU_MAX_SAMPLES[damped]
    assert g.threads == g.tile == voigt_cuda.TAU_THREADS[damped]
    assert g.ntiles == -(-P // g.tile)
    assert g.grid == -(-B // g.samples) * g.ntiles
    if P == 0:
        return  # no CTA (the wrapper launches nothing)
    groups, tiles = _partitions(g, B, P)
    samples = [b for r in groups for b in r]
    pixels = [p for r in tiles for p in r]
    assert samples == list(range(B)) and all(len(r) > 0 for r in groups)
    assert pixels == list(range(P)) and all(len(r) > 0 for r in tiles)
    assert all(len(r) == g.samples for r in groups[:-1])
    if B % g.samples:
        assert len(groups[-1]) == B % g.samples  # the partial last group
    for cta in {0, g.grid // 2, g.grid - 1} if g.grid else ():
        i, j = divmod(cta, g.ntiles)
        assert _block(g, cta, B, P) == (groups[i], tiles[j])


@pytest.mark.parametrize("damped", (False, True))
@pytest.mark.parametrize("B,P", [(1, 1), (3, 23), (13, 257), (101, 600), (7, 2049)])
def test_small_grids_write_each_element_once(B, P, damped):
    """Every CTA's block enumerated: each (sample, pixel) counted once, at
    the geometry's S and at every other S the kernel takes."""
    for S in range(1, voigt_cuda.TAU_MAX_SAMPLES[damped] + 1):
        g = voigt_cuda._tau_layout(B, 22, P, S, voigt_cuda.TAU_THREADS[damped])
        counts = np.zeros((B, P), dtype=np.int64)
        for cta in range(g.grid):
            rows, cols = _block(g, cta, B, P)
            counts[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert np.all(counts == 1), S


@pytest.mark.parametrize("damped", (False, True))
@pytest.mark.parametrize("B", BATCHES + (10**6,))
@pytest.mark.parametrize("T,P", [(22, 1999), (7, 1999), (2, 200000), (400, 5000)])
def test_grid_and_shared_memory_fit_a_hopper_card(B, T, P, damped):
    g = voigt_cuda.tau_geometry(B, T, P, damped)
    assert 0 <= g.grid <= GRID_X_MAX  # a one-dimensional grid: no 65,535 limit on B
    assert g.threads <= 1024
    assert g.smem == 4 * (8 + voigt_cuda.N_TERMS) * T * g.samples <= SMEM_LIMIT


def test_too_many_transitions_for_shared_memory_are_refused():
    with pytest.raises(ValueError, match="shared memory"):
        voigt_cuda.tau_geometry(100, 1700, 1999, False)


@pytest.mark.parametrize("damped", (False, True))
def test_more_ctas_than_a_grid_holds_are_refused(damped):
    with pytest.raises(ValueError, match="CTAs"):
        voigt_cuda.tau_geometry(10**7, 22, 200000, damped)


@pytest.mark.parametrize("damped,B,S", [
    (False, 1, 1), (False, 13, 1), (False, 100, 2), (False, 200, 4), (False, 1000, 4),
    (True, 1, 1), (True, 13, 1), (True, 100, 1), (True, 200, 2), (True, 1000, 2),
])
def test_samples_per_group_follow_the_work_per_sm(damped, B, S):
    """The flagship's shapes on an H100: S grows with B while every SM still
    gets its warps of work; the damped kernel takes at most 2."""
    g = voigt_cuda.tau_geometry(B, 22, 1999, damped)
    assert g.samples == S
    warps = g.grid * g.threads // 32
    assert S == 1 or warps >= voigt_cuda.TAU_WARPS_PER_SM[damped] * voigt_cuda.H100_SMS


def _tau_args(name, B, seed):
    model = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec_multicomp.txt"),
                                      **MODELS[name])
    fwd = make_torch_forward(model, "cpu")
    s, c = fwd.static, fwd.consts()
    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.02, 0.98, (B, s.ndim))
                         .astype(np.float32))
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    dz, gain, av, dnu = tm._line_tables(tm.cube_to_params_core(u, c), c, s, dz)
    return dz, gain, av, dnu, c["d0"], c["c_over_wave"], fwd.tmin, fwd.modes


def _group_emulation(args, g):
    """The kernel's dataflow in plain PyTorch: per CTA, its group's samples
    on its tile's pixels, each sample's sum over the Harris transitions then
    the damped ones (ascending t each), one transition's terms from the
    plain version; samples past B neither computed nor written."""
    dz, gain, av, dnu, d0, cw, tmin, modes = args
    B, T = dz.shape
    P = cw.shape[0]
    order = ([t for t in range(T) if modes[t] != voigt_cuda.MODE_HJERT]
             + [t for t in range(T) if modes[t] == voigt_cuda.MODE_HJERT])
    tau = torch.full((B, P), float("nan"))
    for cta in range(g.grid):
        rows, cols = _block(g, cta, B, P)
        r = slice(rows.start, rows.stop)
        c = slice(cols.start, cols.stop)
        acc = torch.zeros((len(rows), len(cols)))
        for t in order:
            one = slice(t, t + 1)
            acc = acc + voigt_cuda.voigt_tau_plain(
                dz[r, one], gain[r, one], av[r, one], dnu[r, one], d0[one, c], cw[c],
                tmin[one], modes[one])
        assert torch.isnan(tau[r, c]).all()  # written once
        tau[r, c] = acc
    return tau


@pytest.mark.parametrize("name", ("flagship", "narrow", "mixed"))
def test_sample_group_dataflow_matches_the_plain_tau(name):
    """Groups of the instantiation's largest S over B = 7 (a partial last
    group) and 256-pixel tiles give voigt_tau_plain's tau: bit for bit where
    every transition is in one mode (the same sums in the same order), to
    1e-6 of |tau| + 1e-3 on the mixed model, whose damped transition the
    kernel adds last."""
    args = _tau_args(name, 7, seed=11)
    damped = voigt_cuda._any_damped(args[7])
    assert damped == (name != "flagship")
    S = voigt_cuda.TAU_MAX_SAMPLES[damped]
    g = voigt_cuda._tau_layout(7, args[0].shape[1], args[5].shape[0], S, 256)
    assert 7 % S  # the last group is partial
    got = _group_emulation(args, g)
    want = voigt_cuda.voigt_tau_plain(*args)
    assert want.max() > 1.0  # lines, not just continuum
    if name == "mixed":
        err = ((got - want).abs() / (want.abs() + 1e-3)).max().item()
        assert err < 1e-6, err
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,damped", [("flagship", False), ("narrow", True), ("mixed", True)])
def test_instantiation_follows_the_mode_table(name, damped):
    """The wrapper launches the damped instantiation exactly when
    _any_damped finds a strongly damped transition, with that
    instantiation's tiles and samples."""
    modes = _tau_args(name, 1, seed=0)[7]
    assert voigt_cuda._any_damped(modes) is damped
    assert (voigt_cuda.MODE_HJERT in modes.tolist()) is damped
    g = voigt_cuda.tau_geometry(1000, modes.shape[0], 1999, damped)
    assert g.threads == voigt_cuda.TAU_THREADS[damped]
    assert g.samples == voigt_cuda.TAU_MAX_SAMPLES[damped]
