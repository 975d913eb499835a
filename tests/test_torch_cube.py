"""The tables the fused kernel's unit-cube entry is handed, on the CPU.

On a card ``loglike_cube_core`` is one launch of
``voigt_cuda.fused_loglike_cube``, which reads the rows' unit-cube points
and the per-problem tables of ``torch_model.cube_tables``.  Here those
tables are held to what the forward models hold (names, shapes, dtypes,
the problem axis), and fed to the kernel's plain twin, which must give the
PyTorch glue's log L bit for bit: what the kernel reads is then enough to
compute the likelihood the glue computes.  The C entry point's argument
list is read from the CUDA source as text.  The kernel itself is held
against the glue on a card (``tests/test_torch_kernel_gpu.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.models.batched import pad_model_to_npix, stack_problems
from mcalf_torch.ops import voigt_cuda
from mcalf_torch.ops.convolve import gaussian_kernel

TESTDATA = Path(__file__).parents[1] / "testdata"
CSRC = Path(voigt_cuda.__file__).resolve().parents[1] / "csrc"

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    specres=[8.0], Nrange=[12.0, 14.5], zrange=[2.99, 3.01],
)
MODELS = {
    # the flagship with the asymmetric likelihood
    "flagship": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0], Asymmlike=True),
    # brange = 3, 40: every transition strongly damped
    "narrow": dict(_CIV, ncomp=(2, 3), brange=[3.0, 40.0]),
    # a free resolution and continuum, the asymmetric likelihood and
    # Gaussian priors on the first component
    "free": dict(_CIV, ncomp=(2, 3), brange=[10.0, 40.0], specres=[6.0, 10.0],
                 contval=[0.9, 1.1], Asymmlike=True),
    # CIV 1548 + HI 1215 + a filler line
    "mixed": dict(fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "HI 1215"],
                  ncomp=(1, 3), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
                  brange=[5.0, 40.0], zrange=[2.99, 3.01]),
}


def _model(name, fitrange=None):
    kw = dict(MODELS[name])
    if fitrange is not None:
        kw["fitrange"] = fitrange
    m = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec_multicomp.txt"), **kw)
    if name == "free":
        m.gpriors = ["8.0", "1.0", "none", "none"] + [
            v for _ in range(m.ndim - 2) for v in ("none", "none")]
        m.gpriors[6:12] = ["13.5", "0.5", "3.0", "0.001", "20.0", "5.0"]
    return m


def _forwards(name):
    """The solo forward of ``name`` and a stacked one of it and its model
    on a shorter range padded to the same pixels."""
    gp = name == "free"
    full = _model(name)
    short = pad_model_to_npix(_model(name, [(6182.0, 6216.0)]), full.npix)
    s, stacked = stack_problems([full, short], gpriors=gp)
    return make_torch_forward(full, "cpu", gpriors=gp), tm.make_stacked_forward(s, stacked, "cpu")


def _rows(ndim, B, seed):
    """B unit-cube rows, the first ones on the cube's faces."""
    u = np.random.default_rng(seed).uniform(0.02, 0.98, (B, ndim)).astype(np.float32)
    u[0], u[1] = 0.0, 1.0
    u[2, ::2] = 0.0
    u[3, 1::2] = 1.0
    return torch.from_numpy(u)


#: per-problem tables of CubeTables and their trailing shapes
def _trailing(s, K):
    return {
        "lo": (s.ndim,), "hi": (s.ndim,), "zspan": (s.ntrans,), "inv_wrest_cm": (s.ntrans,),
        "gamma": (s.ntrans,), "f": (s.ntrans,), "taps": (K,), "velstep": (), "contval": (),
        "const_term": (), "cdf4": (), "cdf5": (), "grace": (), "gp_mu": (s.ndim,),
        "gp_isig2": (s.ndim,), "gp_norm": (), "d0": (s.ntrans, s.npix), "cw": (s.npix,),
        "data": (s.npix,), "ivar": (s.npix,), "inv_noise": (s.npix,),
    }


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("stacked", (False, True), ids=("solo", "stacked"))
def test_cube_tables_are_the_forwards_buffers(name, stacked):
    """Names, shapes and dtypes of what the cube entry reads, each the
    forward's own buffer (no copy per call), with the problem axis exactly
    on a stacked forward, and the parameter columns of the static spec."""
    solo, sf = _forwards(name)
    fwd = sf if stacked else solo
    s, c = fwd.static, fwd.consts()
    t = tm.cube_tables(c, s)
    assert t._fields == voigt_cuda.CubeTables._fields
    assert set(voigt_cuda._PER_PROBLEM) == set(_trailing(s, 0))
    lead = (2,) if stacked else ()
    K = 2 * s.half + 1
    for k, shape in _trailing(s, K).items():
        x = getattr(t, k)
        if k == "taps" and s.freespecres or k.startswith("gp_") and not s.has_gpriors:
            assert x is None, k
            continue
        assert x.dtype == torch.float32 and tuple(x.shape) == lead + shape, k
        assert x is c[{"cw": "c_over_wave"}.get(k, k)], k
    for k, dtype in (("pidx", torch.int64), ("u_zidx", torch.int64), ("comp_id", torch.float32),
                     ("is_fill", torch.bool), ("tmin", torch.float32), ("modes", torch.int32)):
        x = getattr(t, k)
        assert x.dtype == dtype and tuple(x.shape) == (s.ntrans,) and x is c[k], k
    assert t.startind == s.startind
    assert t.specres_at == (0 if s.freespecres else -1)
    assert t.cont_at == (int(s.freespecres) if s.freecont else -1)
    assert s.has_gpriors == (name == "free") and s.freespecres == s.freecont == (name == "free")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stacked_tables_are_indexed_by_problem(name):
    """Row q of each stacked per-problem table is problem q's solo table,
    and the shared layout is the solo forward's."""
    gp = name == "free"
    models = [_model(name), pad_model_to_npix(_model(name, [(6182.0, 6216.0)]),
                                              _model(name).npix)]
    s, stacked = stack_problems(models, gpriors=gp)
    ts = tm.cube_tables(tm.make_stacked_forward(s, stacked, "cpu").consts(), s)
    for q, m in enumerate(models):
        one = make_torch_forward(m, "cpu", gpriors=gp)
        t1 = tm.cube_tables(one.consts(), one.static)
        for k in voigt_cuda.CubeTables._fields:
            a, b = getattr(ts, k), getattr(t1, k)
            if k in voigt_cuda._PER_PROBLEM and a is not None:
                a = a[q]
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (q, k)
            else:
                assert a == b, (q, k)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("stacked", (False, True), ids=("solo", "stacked"))
def test_plain_twin_of_the_cube_entry_is_the_glue(name, stacked):
    """The tables fed to the kernel's plain twin give loglike_cube_core's
    log L bit for bit on the CPU, rows on the cube's faces included; a
    stacked batch interleaves runs of both problems."""
    solo, sf = _forwards(name)
    fwd = sf if stacked else solo
    s = fwd.static
    u = _rows(s.ndim, 41, seed=len(name))
    prob = None
    if stacked:
        prob = torch.tensor([0] * 9 + [1] * 20 + [0] * 12, dtype=torch.int32)
        want = fwd.loglike_cube(u, prob)
    else:
        want = fwd.loglike_cube(u)
    got = voigt_cuda.fused_loglike_cube(u, prob, tm.cube_tables(fwd.consts(), s),
                                        half=s.half, asymm=s.asymmlike)
    assert got.dtype == torch.float32 and got.shape == (41,)
    assert torch.equal(got, want)
    assert torch.isfinite(want).any()


def test_torch_forward_makes_its_taps_once():
    """A fixed resolution's LSF taps are a buffer of the solo forward, the
    expression the glue evaluated on each call, and its stacked forward
    holds the same taps per problem."""
    solo, sf = _forwards("flagship")
    c, s = solo.consts(), solo.static
    want = gaussian_kernel(((c["fixed_specres"] / 2.354820) / c["velstep"]), s.half)
    assert c["taps"].shape == (2 * s.half + 1,) and torch.equal(c["taps"], want)
    assert torch.equal(sf.consts()["taps"][0], c["taps"])
    assert "taps" not in _forwards("free")[0].consts()


def _c_parameters(entry):
    """(type, name) of each parameter of a C entry point of fused_loglike.cu."""
    src = (CSRC / "fused_loglike.cu").read_text()
    m = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', src, re.S)
    assert m, entry
    out = []
    for p in m.group(1).split(","):
        words = p.replace("*", " * ").split()
        out.append((" ".join(words[:-1]), words[-1]))
    return out


def test_cube_entry_matches_the_c_signature():
    """The wrapper passes the pointers of _CUBE_POINTERS in the order of the
    C entry point's pointer parameters, then its 13 ints and the stream."""
    params = _c_parameters("mcalf_fused_loglike_cube")
    ptrs = [n for ty, n in params if ty.endswith("*")]
    ints = [n for ty, n in params if ty == "int"]
    assert tuple(ptrs[:-1]) == voigt_cuda._CUBE_POINTERS and ptrs[-1] == "stream"
    assert ints == ["B", "T", "P", "half", "tile", "cluster", "smem", "ndim", "startind",
                    "specres_at", "cont_at", "asymm", "damped"]
    assert [n for _, n in params] == list(voigt_cuda._CUBE_POINTERS) + ints + ["stream"]
    types = dict((n, ty) for ty, n in params)
    assert types["pidx"] == types["u_zidx"] == "const long long *"
    assert types["is_fill"] == "const bool *" and types["modes"] == types["prob"] == "const int *"
    occ = [n for _, n in _c_parameters("mcalf_fused_occupancy")]
    assert occ[6:8] == ["damped", "cube"]


def test_cube_inputs_are_checked():
    """What the card's wrapper refuses before a launch: a table of another
    dtype, a stacked table without ``prob``, a parameter column outside the
    row, a fixed resolution without taps."""
    _, sf = _forwards("flagship")
    s = sf.static
    t = tm.cube_tables(sf.consts(), s)
    u = _rows(s.ndim, 4, seed=1)
    prob = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    voigt_cuda._check_cube_inputs(u, prob, t, s.half)
    with pytest.raises(ValueError, match="lo: shape"):
        voigt_cuda._check_cube_inputs(u, None, t, s.half)
    with pytest.raises(ValueError, match="pidx: need a contiguous torch.int64"):
        voigt_cuda._check_cube_inputs(u, prob, t._replace(pidx=t.pidx.int()), s.half)
    with pytest.raises(ValueError, match="u: need a contiguous torch.float32"):
        voigt_cuda._check_cube_inputs(u.double(), prob, t, s.half)
    with pytest.raises(ValueError, match="outside the"):
        voigt_cuda._check_cube_inputs(u, prob, t._replace(cont_at=s.ndim), s.half)
    with pytest.raises(ValueError, match="taps: None"):
        voigt_cuda._check_cube_inputs(u, prob, t._replace(taps=None), s.half)
    with pytest.raises(ValueError, match="prob: shape"):
        voigt_cuda._check_cube_inputs(u, prob[:3].contiguous(), t, s.half)


def test_plain_twin_reads_the_glues_columns():
    """The plain twin runs the glue, which reads a free resolution in column
    0 and a free continuum after it: tables that put them elsewhere are
    refused, not read from the wrong columns."""
    solo, _ = _forwards("free")
    s = solo.static
    t = tm.cube_tables(solo.consts(), s)
    u = _rows(s.ndim, 4, seed=2)
    kw = dict(half=s.half, asymm=s.asymmlike)
    assert torch.equal(voigt_cuda.fused_loglike_cube_plain(u, None, t, **kw), solo.loglike_cube(u))
    for bad in (t._replace(cont_at=0), t._replace(specres_at=2), t._replace(cont_at=3)):
        with pytest.raises(ValueError, match="not the glue's columns"):
            voigt_cuda.fused_loglike_cube_plain(u, None, bad, **kw)
