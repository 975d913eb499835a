"""The slice kernels (``mcalf_torch/csrc/slice_step.cu``) against the torch
ops they replace, on a card.  Marked ``gpu``: they skip without a CUDA
device.  No jax here, so on a machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_slice_gpu.py

* One chord slice iteration through the kernels (``_slice_step`` on a card)
  against ``_slice_step_ops`` on the same inputs, for a dozen iterations in
  a row: every carry tensor, ``n_like``, ``it_total``, the active-row
  counter and the rows handed to the likelihood bit for bit (a NaN where
  the torch ops give a NaN, whatever its payload), the bracket ends by
  value (a zero end may take either sign: no proposal can tell, since
  lo <= 0 <= hi gives the same t = lo + r (hi - lo) with either), at Q = 1
  and 8 problems
  and ndim = 3 and 34, on carries with NaN directions, direction entries
  below 1e-12 (and signed zeros), points on the cube's faces, proposals on
  a face, log L at the constraint, -inf and NaN, chains at their last
  shrink, problems with every pass made and the loop at its cap, over
  every problem's rows and over the eager loop's live subset; and on rows
  of 131 and 150, many times the threads that reduce a row.
* A captured fit of testdata/fit.cfg at a small cap through the CLI, solo
  and as a 2-seed fleet, writes the files the torch ops write (forced by
  a monkeypatched dispatch) byte for byte.
* ``slice_cuda.launches`` counts one launch per slice iteration the card
  ran with the chord bracket, and none with the step-out bracket.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch import cli
from mcalf_torch.ops import slice_cuda, voigt_cuda
from mcalf_torch.sampler import NSConfig, graph
from mcalf_torch.sampler import nested as tn

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor, by_value: bool = False) -> bool:
    """Equal bit for bit (``by_value``: by value, so -0 == +0), a NaN
    matching a NaN of any payload."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    if by_value:
        return torch.equal(a[~na], b[~nb])
    return torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))


#: the carry's bracket ends, compared by value
BY_VALUE = ("lo", "hi")


class _Table:
    """A likelihood that reads each row's value from a (Q, B) table by its
    problem and place (so both paths get the same values whatever the
    point), and keeps the rows it was handed."""

    def __init__(self, table):
        self.table, self.seen = table, []

    def __call__(self, u, prob):
        self.seen.append(u.clone())
        B = self.table.shape[1]
        place = torch.arange(u.shape[0], device=u.device) % B
        return self.table[prob.long(), place]


def _setup(cuda, Q, ndim, *, at_cap, faces=True, B=40, nrep=5, max_shrink=4, seed=0):
    """A chord loop's fixed inputs and a carry with every edge case the
    kernels mirror; returns (x, carry, rng)."""
    rng = np.random.default_rng(seed + 100 * Q + ndim)
    f32 = np.float32
    cfg = NSConfig(ndim=ndim, nlive=2 * B, num_delete=B, num_repeats=nrep,
                   max_shrink=max_shrink).resolved()
    u = rng.random((Q, B, ndim)).astype(f32)
    if faces:
        u[rng.random(u.shape) < 0.06] = 0.0
        u[rng.random(u.shape) < 0.06] = 1.0
    n = rng.normal(size=(Q, nrep, B, ndim))
    pools = (0.3 * n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(f32)
    for val, share in ((1e-13, 0.04), (-1e-13, 0.02), (0.0, 0.03), (-0.0, 0.03)):
        pools[rng.random(pools.shape) < share] = val
    axis = rng.random((Q, nrep, B)) < 0.15
    pools[axis] = np.eye(ndim, dtype=f32)[rng.integers(0, ndim, axis.sum())]
    pools[rng.random((Q, nrep, B)) < 0.05] = np.nan   # a failed Cholesky factor
    table = rng.normal(0.0, 1.0, (Q, B)).astype(f32)
    lstar = rng.normal(-0.5, 0.2, (Q, 1)).astype(f32)
    pick = rng.random((Q, B))
    table[pick < 0.15] = np.broadcast_to(lstar, (Q, B))[pick < 0.15]
    table[(pick >= 0.15) & (pick < 0.25)] = -np.inf
    table[(pick >= 0.25) & (pick < 0.28)] = np.nan
    ll = _Table(torch.tensor(table, device=cuda))
    gens = [torch.Generator(device=cuda).manual_seed(seed + q) for q in range(Q)]
    x = tn._fixed(ll, gens, torch.tensor(pools, device=cuda),
                  torch.tensor(lstar, device=cuda), list(range(Q)), cfg)
    x = x._replace(active=torch.zeros((Q, B), dtype=torch.int64, device=cuda))
    assert x.scratch is not None
    c = tn._init_loop_carry(torch.tensor(u, device=cuda),
                            torch.tensor(rng.normal(size=(Q, B)).astype(f32), device=cuda), x)
    # proposals on a face: an axis direction with lo = -u along it and r = 0
    k = rng.integers(0, ndim, (Q, B))
    on_face = rng.random((Q, B)) < 0.1
    d = c.d.cpu().numpy()
    d[on_face] = np.eye(ndim, dtype=f32)[k[on_face]]
    d[rng.random((Q, B)) < 0.05] = np.nan
    c.d.copy_(torch.tensor(d, device=cuda))
    lo, hi = tn._bracket(c.u, c.d)
    uk = torch.gather(c.u, 2, torch.tensor(k, device=cuda)[..., None])[..., 0]
    face = torch.tensor(on_face, device=cuda)
    c.lo.copy_(torch.where(face, 0.0 - uk, lo))
    c.hi.copy_(hi)
    c.it_pass.copy_(torch.tensor(rng.integers(0, max_shrink, (Q, B)), device=cuda))
    c.it_pass[:, : B // 4] = max_shrink - 1
    passes = rng.integers(0, nrep + 1, (Q, B))
    if Q > 1:
        passes[Q - 1] = nrep  # a problem with every pass made
    c.passes.copy_(torch.tensor(passes, device=cuda))
    if at_cap:
        c.it_total.fill_(x.total_cap - 1)
    r = rng.random((Q, B)).astype(f32)
    r[on_face] = 0.0
    r[rng.random((Q, B)) < 0.05] = 1.0
    x.r.copy_(torch.tensor(r, device=cuda))
    return x, c, rng


def _live(x, Q, B, cuda, subset):
    if not subset:
        return None
    qs = [q for q in range(Q) if q % 3 != 1] or [0]
    idx = torch.tensor(qs, device=cuda)
    return qs, idx, x.rows.reshape(Q, B)[idx].reshape(-1)


def _clone(c):
    return type(c)(*(t.clone() for t in c))


def _iterate_both(cuda, x, c, live, iterations, first_r=True):
    """Iterations of the kernels and of the torch ops from the same carry;
    asserts every tensor after each."""
    Q, B = c.logl.shape
    before = slice_cuda.launches
    for it in range(iterations):
        if not first_r or it > 0:
            for q in range(Q):
                torch.rand((B,), generator=x.gens[q], dtype=torch.float32, device=cuda,
                           out=x.r[q])
        c_ops, act_ops = _clone(c), x.active.clone()
        x.loglike_rows.seen.clear()
        tn._slice_step_ops(c_ops, x._replace(active=act_ops), live)
        seen_ops = x.loglike_rows.seen[:]
        x.loglike_rows.seen.clear()
        tn._slice_step(c, x, live)
        torch.cuda.synchronize()
        for name, a, b in zip(c._fields, c, c_ops):
            assert _same(a, b, by_value=name in BY_VALUE), (it, name)
        assert torch.equal(x.active, act_ops), it
        assert len(x.loglike_rows.seen) == len(seen_ops) == 1
        assert _same(x.loglike_rows.seen[0], seen_ops[0]), it
    assert slice_cuda.launches == before + iterations


@pytest.mark.parametrize("live", (False, True), ids=("all", "live"))
@pytest.mark.parametrize("at_cap", (False, True), ids=("start", "cap"))
@pytest.mark.parametrize("ndim", (3, 34))
@pytest.mark.parametrize("Q", (1, 8))
def test_kernels_are_the_torch_ops_bit_for_bit(cuda, Q, ndim, at_cap, live):
    x, c, _ = _setup(cuda, Q, ndim, at_cap=at_cap)
    _iterate_both(cuda, x, c, _live(x, Q, c.logl.shape[1], cuda, live), 12)
    if at_cap:  # past the cap nothing moves
        assert int(c.it_total) == x.total_cap - 1 + 12
    assert int(x.active.sum()) > 0 or at_cap


@pytest.mark.parametrize("ndim", (131, 150))
def test_kernels_are_the_torch_ops_on_wide_rows(cuda, ndim):
    """Rows of many times the threads that reduce one, starting at every
    4-byte offset of a 16-byte line (131) and at two (150)."""
    x, c, _ = _setup(cuda, 2, ndim, at_cap=False)
    _iterate_both(cuda, x, c, None, 12)


def _write_cfg(path: Path, outdir: Path, run="", ns="") -> Path:
    text = (TESTDATA / "fit.cfg").read_text()
    text = text.replace("datadir = testdata/", f"datadir = {TESTDATA}/")
    text = text.replace("outdir = testdata/output/", f"outdir = {outdir}/")
    text = text.replace("doplot = True", "doplot = False\n" + run)
    text += "\n[ns_settings]\nmax_samples = 500\n" + ns
    path.write_text(text)
    return path


def _files(outdir: Path) -> dict:
    return {p.relative_to(outdir): p.read_bytes() for p in sorted(outdir.rglob("*"))
            if p.is_file() and p.suffix != ".cfg"}


@pytest.mark.parametrize("run", ("", "seeds = 43,44"), ids=("solo", "fleet"))
def test_captured_fit_writes_the_torch_ops_files(cuda, tmp_path, monkeypatch, run):
    out = {}
    for kind in ("kernels", "ops"):
        d = tmp_path / kind
        d.mkdir()
        if kind == "ops":
            monkeypatch.setattr(tn, "_on_kernels", lambda c, x: False)
        before = slice_cuda.launches
        assert cli.main([str(_write_cfg(d / "fit.cfg", d, run))]) == 0
        out[kind] = (_files(d), slice_cuda.launches - before)
    assert out["kernels"][0] and out["kernels"][0] == out["ops"][0]
    assert out["kernels"][1] > 0 and out["ops"][1] == 0


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_slice_launches_count_the_card_iterations(cuda, tmp_path, bracket):
    """One slice_update launch per slice iteration the card ran (the
    warm-up's and every replay's), and none with the step-out bracket,
    whose bookkeeping stays in torch ops; the fused launches add the live
    set's first evaluation."""
    before = (slice_cuda.launches, voigt_cuda.cube_launches, graph.stats["iterations"],
              graph.stats["warmups"])
    cfg = _write_cfg(tmp_path / "fit.cfg", tmp_path, ns=f"bracket = {bracket}\n")
    assert cli.main([str(cfg)]) == 0
    slices = slice_cuda.launches - before[0]
    cube = voigt_cuda.cube_launches - before[1]
    iterations = (graph.stats["iterations"] - before[2]) + (graph.stats["warmups"] - before[3])
    print(f"{bracket}: slice_update launches {slices}, cube launches {cube}, "
          f"loop iterations {iterations}")
    if bracket == "chord":
        assert slices == iterations == cube - 1
    else:
        assert slices == 0 and cube == iterations + 1
