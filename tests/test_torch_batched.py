"""Stacked problems in the port against the JAX package: stack_problems,
index_consts and pad_model_to_npix array for array, the stacked likelihood
per problem against mcalf_tpu's XLA path, and the stacked plain fused
likelihood against per-problem calls bit for bit.

Tolerances (the JAX package's own fused-vs-XLA bar, as in
tests/test_torch_likelihood.py): log L to rtol 1e-5 / atol 0.05, the -inf
pattern exactly.  The host copies and the stacked-vs-solo comparisons are
exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_tpu.models import AbsorptionModel as JModel
from mcalf_tpu.models import batched as jbatched
from mcalf_tpu.models import jax_model as jm
from mcalf_torch.models import AbsorptionModel as TModel
from mcalf_torch.models import batched as tbatched
from mcalf_torch.models import make_torch_forward
from mcalf_torch.models import torch_model as tm
from mcalf_torch.ops import voigt_cuda

TESTDATA = Path(__file__).parents[1] / "testdata"


_CIV = dict(
    fitlines=["CIV 1548", "CIV 1550"], specres=[8.0], Nrange=[12.0, 14.5],
    brange=[10.0, 40.0], zrange=[2.99, 3.01],
)
#: (spectrum file, fit range): the second is shorter and is padded to the
#: first's 1999 pixels
SPECTRA = (
    ("civ_mock_spec.txt", (6180.0, 6220.0)),
    ("civ_mock_spec_multicomp.txt", (6182.0, 6216.0)),
)
KINDS = {
    "transdim": dict(ncomp=(1, 2)),
    "asymmlike": dict(ncomp=(2, 4), nfill=1, Asymmlike=True),
}


def _models(cls, kind):
    ms = [
        cls.from_file(str(TESTDATA / f), fitrange=[r], **_CIV, **KINDS[kind])
        for f, r in SPECTRA
    ]
    return ms


def _padded(pad, models):
    npix = max(m.npix for m in models)
    return [pad(m, npix) for m in models]


def _cube(ndim, n, seed):
    return np.random.default_rng(seed).uniform(0.02, 0.98, size=(n, ndim)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stack_problems_matches_jax(kind):
    jms = _models(JModel, kind)
    tms = _models(TModel, kind)
    assert tms[1].npix < tms[0].npix
    jp = _padded(jbatched.pad_model_to_npix, jms)
    tp = _padded(tbatched.pad_model_to_npix, tms)
    for a, b in zip(jp, tp):
        assert (a.npix, a.velstep) == (b.npix, b.velstep)
        for attr in ("obj_wl", "obj", "obj_noise", "valid", "bounds_lo", "bounds_hi"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr), err_msg=attr)
    js, jst = jbatched.stack_problems(jp, use_pallas=False)
    ts, tst = tbatched.stack_problems(tp)
    assert {f: getattr(js, f) for f in ts.__dataclass_fields__} == ts.__dict__
    assert set(jst) == set(tst)
    for k in jst:
        a, b = np.asarray(jst[k]), np.asarray(tst[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the static tables stay unstacked; everything else has the problem axis
    for k in tst:
        assert k in tbatched.STATIC_KEYS or tst[k].shape[0] == 2, k
    for i in range(2):
        want = tm.build_consts(tp[i])
        got = tbatched.index_consts(tst, i)
        jgot = jbatched.index_consts(jst, i)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], np.asarray(jgot[k]), err_msg=k)


def test_stack_problems_refuses_other_structure():
    kw = dict(fitrange=[(6180.0, 6220.0)], **_CIV)
    spec = str(TESTDATA / "civ_mock_spec.txt")
    for mod, cls in ((tbatched, TModel), (jbatched, JModel)):
        a = cls.from_file(spec, ncomp=(1, 1), **kw)
        b = cls.from_file(spec, ncomp=(1, 2), **kw)
        with pytest.raises(ValueError, match="problem 1 has incompatible structure"):
            mod.stack_problems([a, b])
        with pytest.raises(ValueError, match="need at least one model"):
            mod.stack_problems([])
        with pytest.raises(ValueError, match="pixels > target"):
            mod.pad_model_to_npix(a, a.npix - 1)
        assert mod.pad_model_to_npix(a, a.npix) is a


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stacked_loglike_matches_jax(kind):
    """StackedForward over two different spectra (one padded), rows of the
    two problems interleaved, against mcalf_tpu's XLA likelihood of each
    problem alone."""
    jp = _padded(jbatched.pad_model_to_npix, _models(JModel, kind))
    tp = _padded(tbatched.pad_model_to_npix, _models(TModel, kind))
    js, jst = jbatched.stack_problems(jp, use_pallas=False)
    ts, tst = tbatched.stack_problems(tp)
    fwd = tm.make_stacked_forward(ts, tst, "cpu")
    assert fwd.nprob == 2 and "taps" in fwd.consts()
    u = _cube(ts.ndim, 24, seed=11)
    if kind == "asymmlike":
        u[:6, ts.startind] = 0.99  # some rows pass the asymmlike gate
    prob = torch.tensor([0, 1] * 12, dtype=torch.int32)
    got = fwd.loglike_cube(torch.from_numpy(u), prob).numpy()
    for i in range(2):
        rows = prob.numpy() == i
        want = np.asarray(jm.loglike_cube_core(u[rows], c=jbatched.index_consts(jst, i), s=js))
        g, w = got[rows].astype(np.float64), want.astype(np.float64)
        assert np.array_equal(np.isfinite(g), np.isfinite(w)), (g, w)
        fin = np.isfinite(g)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=0.05)
    if kind == "asymmlike":
        assert not np.all(np.isfinite(got)) and np.any(np.isfinite(got))
    # the raw stacked constants (taps made per row) agree with the module's
    c = tm.consts_from_numpy(tst, "cpu")
    c.update(tmin=fwd.tmin, modes=fwd.modes)
    raw = tm.loglike_cube_core(torch.from_numpy(u), c, ts, prob=prob).numpy()
    np.testing.assert_allclose(raw, got, rtol=1e-6)


@pytest.mark.parametrize("B", (1, 7, 20))
def test_stacked_rows_are_the_solo_rows_bit_for_bit(B):
    """A batch of contiguous blocks, one per problem (a fleet's layout), is
    each problem's own batch bit for bit: through the whole likelihood and
    through the plain fused kernel alone."""
    tp = _padded(tbatched.pad_model_to_npix, _models(TModel, "transdim"))
    ts, tst = tbatched.stack_problems(tp + tp[:1])
    fwd = tm.make_stacked_forward(ts, tst, "cpu")
    solos = [make_torch_forward(m, "cpu") for m in tp + tp[:1]]
    u = torch.from_numpy(_cube(ts.ndim, 3 * B, seed=B))
    prob = torch.arange(3, dtype=torch.int32).repeat_interleave(B)
    got = fwd.loglike_cube(u, prob)
    want = torch.cat([solos[q].loglike_cube(u[q * B:(q + 1) * B]) for q in range(3)])
    assert torch.equal(got, want)

    # the plain fused kernel with the problem axis against per-problem calls
    c = tm.row_consts(fwd.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    args = tm.fused_args(tm.cube_to_params_core(u, c), c, ts, dz=dz, prob=prob)
    kw = dict(half=ts.half, asymm=True)
    stacked = voigt_cuda.fused_loglike(*args, **kw, prob=prob)
    d0, cw, data, ivar, inv_noise = args[4:9]
    for q in range(3):
        rows = slice(q * B, (q + 1) * B)
        one = voigt_cuda.fused_loglike_plain(
            *(a[rows] for a in args[:4]), d0[q], cw[q], data[q], ivar[q], inv_noise[q],
            args[9][rows], args[10][rows], *args[11:], **kw,
        )
        for s, o in zip(stacked, one):
            assert torch.equal(s[rows], o)

