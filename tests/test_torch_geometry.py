"""The fused kernel's launch geometry (``voigt_cuda.fused_geometry``), on the
CPU: how one sample's spectrum is laid over a thread block cluster, and a
plain emulation of the kernel's tile, halo and reduction dataflow held
against the plain likelihood.  Also the host-side mode-table flag that picks
the kernel's instantiation.  Nothing here needs a card: the CUDA source's
constants are read as text.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcalf_torch.ops import voigt_cuda
from mcalf_torch.ops.faddeeva import N_TERMS

CSRC = Path(voigt_cuda.__file__).resolve().parents[1] / "csrc"

#: (T, P, half) of the models the port runs: the flagship and the narrow
#: flagship (22 transitions on testdata/fit.cfg's 1,999 pixels, a 23-tap
#: LSF), the asymmlike multicomponent model (9), the CIV + HI mixed model (7)
MODEL_SHAPES = [(22, 1999, 11), (9, 1999, 11), (7, 1999, 11)]
RAGGED_SHAPES = [
    (T, P, half)
    for T in (2, 22)
    for P in (1, 23, 255, 256, 257, 600, 2048, 2049, 5000)
    for half in (0, 11)
    if P > 2 * half
]
LONG_SHAPES = [(2, 65536, 11), (22, 65536, 11), (2, 200000, 0), (22, 0, 11)]
ALL_SHAPES = MODEL_SHAPES + RAGGED_SHAPES + LONG_SHAPES


def _source_constant(name: str, path: Path) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", path.read_text())
    assert m, f"{name} not in {path}"
    return m.group(1).strip()


def test_constants_match_the_cuda_source():
    cu = CSRC / "fused_loglike.cu"
    assert int(_source_constant("kThreads", cu)) == voigt_cuda.THREADS
    assert int(_source_constant("kMaxCluster", cu)) == voigt_cuda.MAX_CLUSTER == 8
    assert _source_constant("kLineWords", CSRC / "voigt_h.cuh") == "8 + kTerms"
    assert voigt_cuda._LINE_WORDS == 8 + N_TERMS


@pytest.mark.parametrize("T,P,half", ALL_SHAPES)
def test_every_pixel_has_one_owner(T, P, half):
    g = voigt_cuda.fused_geometry(T, P, half)
    assert 1 <= g.cluster <= voigt_cuda.MAX_CLUSTER
    assert g.threads == voigt_cuda.THREADS and g.halo == half
    tiles = g.tiles(P)
    assert len(tiles) == g.cluster
    owned = np.concatenate([np.arange(a, b) for a, b in tiles])
    np.testing.assert_array_equal(owned, np.arange(P))
    if P > 0:
        assert all(b > a for a, b in tiles), tiles
    # the C entry point's own check of the geometry
    assert g.tile * g.cluster >= P
    if g.cluster > 1:
        assert g.tile * (g.cluster - 1) < P and g.tile >= half


@pytest.mark.parametrize("T,P,half", ALL_SHAPES)
def test_halos_come_from_the_neighbours_inside_the_spectrum(T, P, half):
    g = voigt_cuda.fused_geometry(T, P, half)
    tiles = g.tiles(P)
    for r, (a, b) in enumerate(tiles):
        left = range(a - half, a) if r > 0 and half else range(0)
        right = range(b, min(b + half, P)) if r + 1 < g.cluster and half else range(0)
        for p in left:
            assert 0 <= p < P and tiles[r - 1][0] <= p < tiles[r - 1][1]
        for p in right:
            assert 0 <= p < P and tiles[r + 1][0] <= p < tiles[r + 1][1]
        # every interior pixel's LSF window lies in the tile and its halo
        have = set(range(a, b)) | set(left) | set(right)
        for p in range(max(a, half), min(b, P - half)):
            assert set(range(p - half, p + half + 1)) <= have, (r, p)


@pytest.mark.parametrize("T,P,half", ALL_SHAPES)
def test_shared_memory_fits_a_hopper_cta(T, P, half):
    g = voigt_cuda.fused_geometry(T, P, half)
    assert g.smem == 4 * (voigt_cuda._LINE_WORDS * T + 2 * half + 1 + g.tile + 2 * half)
    assert g.smem <= 232448


@pytest.mark.parametrize("T,P,half", MODEL_SHAPES)
def test_production_batch_fills_the_card(T, P, half):
    """B=100 launches at least one CTA per SM of an H100 (132)."""
    g = voigt_cuda.fused_geometry(T, P, half)
    assert (g.cluster, g.tile) == (8, 250)
    assert 100 * g.cluster >= 132


@pytest.mark.parametrize("T,P,half", [(1700, 10, 0), (2, 200000, 30000), (7000, 1999, 11)])
def test_too_large_for_shared_memory_is_refused(T, P, half):
    with pytest.raises(ValueError, match="shared memory"):
        voigt_cuda.fused_geometry(T, P, half)
    with pytest.raises(ValueError, match="shared memory"):
        voigt_cuda.check_supported(T, P, half)


def _inputs(T, P, half, B, seed):
    """fused_loglike's arguments for a synthetic spectrum: T Harris lines
    (modes 0 and 1) placed across P pixels, data made from a perturbed
    model, a shared (1, K) or per-sample (B, K) box LSF."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    centers = rng.uniform(0.0, max(P - 1, 1), size=T)
    d0 = (np.arange(P)[None, :] - centers[:, None]) * 2.0
    cw = np.full(P, 1.0)
    dz = rng.normal(0.0, 1e-3, (B, T))
    gain = rng.uniform(0.1, 2.0, (B, T))
    av = rng.uniform(1e-4, 5e-4, (B, T))
    dnu = rng.uniform(4.0, 12.0, (B, T))
    data = 1.0 - 0.3 * rng.uniform(size=P)
    K = 2 * half + 1
    kern = np.full((B if seed % 2 else 1, K), 1.0 / K)
    cont = rng.uniform(0.9, 1.1, B if seed % 2 else 1)
    modes = torch.tensor([t % 2 for t in range(T)], dtype=torch.int32)
    tmin = np.where(modes.numpy() == 1, 21.6, 0.0)
    return (f32(dz), f32(gain), f32(av), f32(dnu), f32(d0), f32(cw), f32(data),
            f32(np.full(P, 50.0)), f32(np.full(P, 7.0)), f32(kern), f32(cont),
            f32(tmin), modes)


def _cluster_emulation(args, half, asymm):
    """The kernel's dataflow in plain PyTorch: exp(-tau) per tile, each
    CTA's [left halo | tile | right halo] filled from its neighbours' tiles
    only, the 'same_edge' convolution of its interior pixels, per-tile
    partial chi^2 and counts, summed in rank order."""
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, modes = args
    B, T = dz.shape
    P = cw.shape[0]
    g = voigt_cuda.fused_geometry(T, P, half)
    flux = torch.exp(-voigt_cuda.voigt_tau_plain(dz, gain, av, dnu, d0, cw, tmin, modes))
    tiles = [flux[:, a:b] for a, b in g.tiles(P)]
    chi2 = torch.zeros(B)
    n4 = torch.zeros(B)
    n5 = torch.zeros(B)
    K = 2 * half + 1
    for r, (a, b) in enumerate(g.tiles(P)):
        left = tiles[r - 1][:, g.tile - half :] if r > 0 and half else flux[:, :0]
        right = tiles[r + 1][:, : min(half, P - b)] if r + 1 < g.cluster and half else flux[:, :0]
        buf = torch.cat([left, tiles[r], right], dim=1)
        off = left.shape[1]
        m = tiles[r].clone()
        for i, p in enumerate(range(a, b)):
            if half > 0 and half <= p < P - half:
                window = buf[:, off + i - half : off + i + half + 1]
                m[:, i] = torch.sum(window * kern.expand(B, K), dim=1)
        m = m * cont.expand(B)[:, None]
        res = data[a:b] - m
        chi2 += torch.sum(ivar[a:b] * res * res, dim=1)
        if asymm:
            rn = res * inv_noise[a:b]
            n4 += torch.sum(rn > 4.0, dim=1)
            n5 += torch.sum(rn > 5.0, dim=1)
    return chi2, n4, n5


@pytest.mark.parametrize("P", (23, 257, 600, 2049))
@pytest.mark.parametrize("half", (0, 11))
def test_cluster_dataflow_matches_the_plain_likelihood(P, half):
    """Tiles, halos from the neighbours and the rank-order sum give the plain
    likelihood: chi^2 to rtol 1e-5 (float32 sums in another order), the
    outlier counts exactly."""
    args = _inputs(3, P, half, B=4, seed=P + half)
    emu = _cluster_emulation(args, half, asymm=True)
    want = voigt_cuda.fused_loglike_plain(*args, half=half, asymm=True)
    np.testing.assert_allclose(emu[0].numpy(), want[0].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(emu[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(emu[2].numpy(), want[2].numpy())
    # the CPU route of the wrapper is the plain version
    got = voigt_cuda.fused_loglike(*args, half=half, asymm=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_any_damped_is_read_once_per_table_and_follows_changes():
    modes = torch.tensor([1, 1, 1], dtype=torch.int32)
    assert voigt_cuda._any_damped(modes) is False
    assert voigt_cuda._DAMPED[id(modes)][0]() is modes
    other = torch.tensor([1, 2, 1], dtype=torch.int32)
    assert voigt_cuda._any_damped(other) is True
    assert voigt_cuda._any_damped(modes) is False
    modes[1] = 2  # in place: a new version of the same tensor
    assert voigt_cuda._any_damped(modes) is True
    key = id(other)
    del other
    assert key not in voigt_cuda._DAMPED
