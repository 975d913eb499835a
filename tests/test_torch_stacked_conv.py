"""Stacked problems outside the fused kernel: the likelihood in
``conv_mode='wrap'`` and ``'same'``, where each row's model flux comes from
``voigt_tau`` with the problem axis and its residuals from its own
problem's data.

* The stacked log-likelihood of two different spectra (one padded), rows of
  the two problems interleaved, against mcalf_tpu's
  ``loglike_cube_core(u, index_consts(st, q), spec)`` for each problem, on
  the flagship (windowed Harris), the narrow flagship (``brange = 3, 40``:
  the full hjert) and the asymmlike model; and every stacked row the
  port's solo row bit for bit (a block of one problem's rows its solo
  batch).
* ``voigt_tau_plain`` with ``prob`` equal to one call per problem.
* ``fit_many(conv_mode=...)`` members are the solo runs bit for bit, eager
  and in the captured loop's blocks (run here uncaptured).

Tolerances (the JAX package's fused-vs-XLA bar, as in
tests/test_torch_batched.py): log L to rtol 1e-5 / atol 0.05, the -inf
pattern exactly; the stacked-against-solo comparisons are exact.
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
from mcalf_torch.parallel import fit_many
from mcalf_torch.sampler import NSConfig, finalize, nested_sample
from mcalf_torch.sampler.nested import nested_sample_stacked, unstack_results

TESTDATA = Path(__file__).parents[1] / "testdata"


_CIV = dict(
    fitlines=["CIV 1548", "CIV 1550"], specres=[8.0], Nrange=[12.0, 14.5],
    zrange=[2.99, 3.01],
)
KINDS = {
    "flagship": dict(ncomp=(8, 11), brange=[10.0, 40.0]),
    "narrow": dict(ncomp=(8, 11), brange=[3.0, 40.0]),
    "asymmlike": dict(ncomp=(2, 4), nfill=1, brange=[10.0, 40.0], Asymmlike=True),
}
#: the full fit range, and a shorter one padded to its 1999 pixels
RANGES = ((6180.0, 6220.0), (6182.0, 6216.0))
ROWS = 6


def _padded(cls, pad, kind):
    spec = str(TESTDATA / "civ_mock_spec_multicomp.txt")
    ms = [cls.from_file(spec, fitrange=[r], **_CIV, **KINDS[kind]) for r in RANGES]
    assert ms[1].npix < ms[0].npix
    return [pad(m, ms[0].npix) for m in ms]


def _cube(ndim, n, seed):
    return np.random.default_rng(seed).uniform(0.02, 0.98, size=(n, ndim)).astype(np.float32)


def _rows(ndim, kind):
    """2 ROWS unit-cube rows; for the asymmlike model rows 52, 57, 69 and 76
    of the draw pass its gate on one spectrum or both, the rest fail."""
    u = _cube(ndim, 200, seed=0)
    return u[[52, 57, 69, 76, 0, 1, 2, 3, 4, 5, 6, 7]] if kind == "asymmlike" else u[:2 * ROWS]


@pytest.mark.parametrize("mode", ("wrap", "same"))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stacked_loglike_matches_jax(kind, mode):
    jp = _padded(JModel, jbatched.pad_model_to_npix, kind)
    tp = _padded(TModel, tbatched.pad_model_to_npix, kind)
    js, jst = jbatched.stack_problems(jp, conv_mode=mode, use_pallas=False)
    ts, tst = tbatched.stack_problems(tp, conv_mode=mode)
    fwd = tm.make_stacked_forward(ts, tst, "cpu")
    u = _rows(ts.ndim, kind)
    prob = torch.tensor([0, 1] * ROWS, dtype=torch.int32)
    got = fwd.loglike_cube(torch.from_numpy(u), prob).numpy()
    for q in range(2):
        rows = prob.numpy() == q
        want = np.asarray(jm.loglike_cube_core(u[rows], c=jbatched.index_consts(jst, q), s=js))
        g, w = got[rows].astype(np.float64), want.astype(np.float64)
        assert np.array_equal(np.isfinite(g), np.isfinite(w)), (g, w)
        fin = np.isfinite(g)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=0.05)
        # the port's solo rows, bit for bit: each interleaved row is a run
        # of one row, so it is the solo batch of that row (on the CPU an
        # element's bits depend on its place in the batch), and a block of
        # one problem's rows is the solo batch of those rows
        solo = make_torch_forward(tp[q], "cpu", conv_mode=mode).loglike_cube
        for r in np.nonzero(rows)[0]:
            assert torch.equal(solo(torch.from_numpy(u[r:r + 1])), torch.from_numpy(got[r:r + 1]))
        block = torch.tensor([q] * ROWS + [1 - q] * ROWS, dtype=torch.int32)
        ub = torch.from_numpy(np.concatenate([u[rows], u[~rows]]))
        assert torch.equal(fwd.loglike_cube(ub, block)[:ROWS], solo(ub[:ROWS]))
    if kind == "asymmlike":
        assert np.isfinite(got).any() and not np.isfinite(got).all()
    else:
        assert np.isfinite(got).all()


@pytest.mark.parametrize("kind", ("flagship", "narrow"))
def test_stacked_tau_plain_is_one_call_per_problem(kind):
    """voigt_tau_plain with prob (rows of three problems in runs of 1, 2
    and 3) is each problem's own call bit for bit."""
    tp = _padded(TModel, tbatched.pad_model_to_npix, kind)
    ts, tst = tbatched.stack_problems(tp + tp[:1], conv_mode="wrap")
    fwd = tm.make_stacked_forward(ts, tst, "cpu")
    prob = torch.tensor([0, 1, 1, 2, 2, 2, 0, 1], dtype=torch.int32)
    c = tm.row_consts(fwd.consts(), prob)
    u = torch.from_numpy(_cube(ts.ndim, len(prob), seed=3))
    p = tm.cube_to_params_core(u, c)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    targs = (lambda a: a[:6] + a[11:])(tm.fused_args(p, c, ts, dz=dz, prob=prob))
    got = voigt_cuda.voigt_tau(*targs, prob=prob)
    d0, cw = targs[4], targs[5]
    for q in range(3):
        rows = (prob == q).nonzero().squeeze(1)
        for r in rows.tolist():
            one = voigt_cuda.voigt_tau_plain(*(a[r:r + 1] for a in targs[:4]), d0[q], cw[q],
                                             *targs[6:])
            assert torch.equal(got[r:r + 1], one)


def _anchor(spec="civ_mock_spec.txt"):
    return TModel.from_file(str(TESTDATA / spec), fitrange=[(6180.0, 6220.0)], ncomp=(1, 1),
                            **dict(_CIV, brange=[10.0, 40.0]))


#: the fleet's settings; canon_layout as fit_many sets it for these models
FLEET_KW = dict(ndim=4, nlive=40, num_repeats=3, max_samples=400)


@pytest.mark.parametrize("mode", ("wrap", "same"))
def test_fit_many_members_are_solo_runs(mode):
    """Two seeds of one spectrum and a second spectrum as one fleet in
    ``mode``: each member is that problem's solo ``nested_sample``, bit for
    bit, and the eager fleet is the fleet run in blocks of the captured
    loop's body."""
    models = [_anchor(), _anchor(), _anchor("civ_mock_spec_multicomp.txt")]
    cfg = NSConfig(canon_layout=models[0].canon_layout(), **FLEET_KW)
    seeds = (5, 6, 5)
    gens = lambda: [torch.Generator().manual_seed(s) for s in seeds]
    res = fit_many(models, cfg, mesh=["cpu"], conv_mode=mode, generators=gens())
    for m, s, member in zip(models, seeds, unstack_results(res)):
        one = nested_sample(make_torch_forward(m, "cpu", conv_mode=mode).loglike_cube,
                            torch.Generator().manual_seed(s), cfg, "cpu")
        assert float(member.logz).hex() == float(one.logz).hex()
        assert (member.n_like, member.n_iter) == (one.n_like, one.n_iter)
        for k in ("samples_u", "logl", "logw", "birth_logl"):
            assert torch.equal(getattr(member, k), getattr(one, k)), k
    spec, stacked = tbatched.stack_problems(models, conv_mode=mode)
    fwd = tm.make_stacked_forward(spec, stacked, "cpu")
    blocks = nested_sample_stacked(fwd.loglike_cube, gens(), cfg, "cpu", _loop="blocks")
    for member, final in zip(unstack_results(res), blocks):
        b = finalize(final, cfg)
        assert float(b.logz).hex() == float(member.logz).hex()
        assert torch.equal(b.samples_u, member.samples_u)


def test_no_stacked_mode_is_refused():
    """The stacked likelihood takes every convolution mode the solo one
    does (no NotImplementedError is left in the port)."""
    import mcalf_torch

    root = Path(mcalf_torch.__file__).parent
    assert not [p for p in root.rglob("*.py") if "NotImplementedError" in p.read_text()]
