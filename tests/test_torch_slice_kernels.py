"""The slice kernels' dispatch and wrapper checks on the CPU
(``mcalf_torch/ops/slice_cuda.py``, ``sampler/nested.py::_slice_step``).

* The kernels are taken on a CUDA device with the chord bracket only: the
  CPU and the step-out bracket run the torch ops of ``_slice_step_ops``,
  make no scratch buffers, and count no ``slice_cuda.launches``.
* The wrappers raise on tensors off a card, and on a wrong dtype, shape or
  layout, before anything reaches the card.
The kernels themselves against the torch ops, bit for bit, run only on a
card: tests/test_torch_slice_gpu.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcalf_torch.ops import slice_cuda
from mcalf_torch.sampler import NSConfig, nested_sample
from mcalf_torch.sampler import nested as tn

Q, B, NDIM, R = 2, 5, 4, 6


def _gauss(mus):
    mus = torch.tensor(mus, dtype=torch.float32)

    def rows(u, prob):
        return -0.5 * torch.sum(((u - mus[prob.long()]) / 0.1) ** 2, dim=-1)

    return rows


def _setup(bracket):
    cfg = NSConfig(ndim=NDIM, nlive=2 * B, num_delete=B, num_repeats=R,
                   bracket=bracket, stepout_budget=4).resolved()
    rng = np.random.default_rng(3)
    mus = rng.uniform(0.3, 0.7, (Q, NDIM))
    ll = _gauss(mus)
    u = torch.tensor(np.clip(mus[:, None] + rng.normal(0, 0.05, (Q, B, NDIM)), 0, 1),
                     dtype=torch.float32)
    logl = ll(u.reshape(-1, NDIM), torch.arange(Q).repeat_interleave(B)).reshape(Q, B)
    n = rng.normal(size=(Q, R, B, NDIM))
    pools = torch.tensor(0.3 * n / np.linalg.norm(n, axis=-1, keepdims=True),
                         dtype=torch.float32)
    so = None
    if bracket == "stepout":
        draws = [tn._stepout_pools(torch.Generator().manual_seed(5 + q), cfg, B, "cpu")
                 for q in range(Q)]
        so = tuple(torch.stack(t) for t in zip(*draws))
    gens = [torch.Generator().manual_seed(9 + q) for q in range(Q)]
    x = tn._fixed(ll, gens, pools, logl.min(dim=1).values - 0.5, list(range(Q)), cfg, so)
    return x, tn._init_loop_carry(u, logl, x)


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_cpu_takes_the_torch_ops_and_makes_no_scratch(bracket, monkeypatch):
    x, c = _setup(bracket)
    assert x.scratch is None and not tn._on_kernels(c, x)

    def refuse(*a, **k):
        raise AssertionError("a slice kernel was called on the CPU")

    monkeypatch.setattr(slice_cuda, "slice_propose", refuse)
    monkeypatch.setattr(slice_cuda, "slice_update", refuse)
    before = slice_cuda.launches
    tn._block(c, x, 4)
    assert slice_cuda.launches == before
    assert int(c.it_total) == 4 and int(c.n_like.sum()) > 0


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_step_is_the_torch_ops_on_the_cpu(bracket):
    """On the CPU, _slice_step is _slice_step_ops: the same carry bit for bit."""
    x, c = _setup(bracket)
    _, c2 = _setup(bracket)
    for _ in range(6):
        torch.rand((Q, B), generator=torch.Generator().manual_seed(int(c.it_total)),
                    out=x.r)
        tn._slice_step(c, x)
        tn._slice_step_ops(c2, x)
    for a, b in zip(c, c2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cuda,bracket,kernels", [
    (True, "chord", True), (True, "stepout", False),
    (False, "chord", False), (False, "stepout", False)])
def test_kernels_only_on_a_card_with_the_chord(cuda, bracket, kernels):
    x, _ = _setup(bracket)
    c = SimpleNamespace(u=SimpleNamespace(is_cuda=cuda))
    assert tn._on_kernels(c, x) is kernels


@pytest.mark.parametrize("bracket", ("chord", "stepout"))
def test_cpu_fit_counts_no_slice_launches(bracket):
    cfg = NSConfig(ndim=NDIM, nlive=20, num_repeats=4, max_samples=60, bracket=bracket)
    before = slice_cuda.launches
    res = nested_sample(lambda u: -0.5 * torch.sum(((u - 0.5) / 0.1) ** 2, dim=-1),
                        torch.Generator().manual_seed(1), cfg, "cpu")
    assert res.n_like > cfg.nlive and slice_cuda.launches == before


def test_wrappers_raise_off_a_card():
    x, c = _setup("chord")
    s = slice_cuda.scratch(Q, B, NDIM, "cpu")
    with pytest.raises(ValueError, match="run on cuda, not cpu"):
        slice_cuda.slice_propose(**_propose(c, x.r, s), nrep=R, total_cap=x.total_cap)
    with pytest.raises(ValueError, match="run on cuda, not cpu"):
        slice_cuda.slice_update(**_update(c, x.pools, x.lstar, torch.zeros((Q, B)), s, None),
                                max_shrink=x.max_shrink)


def _propose(c, r, s):
    """slice_propose's tensors from the loop's carry, by name."""
    return dict(u=c.u, d=c.d, lo=c.lo, hi=c.hi, passes=c.passes, it_total=c.it_total,
                n_like=c.n_like, r=r, s=s)


def _update(c, pools, lstar, ll, s, active):
    """slice_update's tensors from the loop's carry, by name."""
    return dict(u=c.u, logl=c.logl, d=c.d, lo=c.lo, hi=c.hi, it_pass=c.it_pass,
                passes=c.passes, it_total=c.it_total, active=active, pools=pools,
                lstar=lstar, ll=ll, s=s)


def _checks():
    x, c = _setup("chord")
    s = slice_cuda.scratch(Q, B, NDIM, "cpu")
    ll = torch.zeros((Q, B))
    return x, c, s, ll


def test_checks_pass_the_loops_own_tensors():
    x, c, s, ll = _checks()
    slice_cuda._check_propose(**_propose(c, x.r, s))
    slice_cuda._check_update(**_update(c, x.pools, x.lstar, ll, s, None))
    slice_cuda._check_update(**_update(c, x.pools, x.lstar, ll, s,
                                       torch.zeros((Q, B), dtype=torch.int64)))


@pytest.mark.parametrize("case,match", [
    ("u_double", "u: need a contiguous torch.float32"),
    ("passes_int64", "passes: need a contiguous torch.int32"),
    ("r_shape", r"r: shape \(2, 4\) != \(2, 5\)"),
    ("u_eval_strided", "u_eval: need a contiguous"),
    ("running_float", "running: need a contiguous torch.bool"),
    ("u_2d", r"u: shape \(10, 4\), need \(Q, B, ndim\)"),
    ("n_like_int32", "n_like: need a contiguous torch.int64"),
])
def test_propose_check_raises(case, match):
    x, c, s, _ = _checks()
    r = x.r
    if case == "u_double":
        c = c._replace(u=c.u.double())
    elif case == "passes_int64":
        c = c._replace(passes=c.passes.long())
    elif case == "r_shape":
        r = r[:, :4].contiguous()
    elif case == "u_eval_strided":
        s = s._replace(u_eval=torch.zeros((Q, NDIM, B)).transpose(1, 2))
    elif case == "running_float":
        s = s._replace(running=s.running.float())
    elif case == "u_2d":
        c = c._replace(u=c.u.reshape(Q * B, NDIM))
    elif case == "n_like_int32":
        c = c._replace(n_like=c.n_like.int())
    with pytest.raises(ValueError, match=match):
        slice_cuda._check_propose(**_propose(c, r, s))


@pytest.mark.parametrize("case,match", [
    ("pools_shape", r"pools: shape \(2, 6, 4, 4\) != \(2, 6, 5, 4\)"),
    ("lstar_flat", r"lstar: shape \(2,\) != \(2, 1\)"),
    ("ll_double", "ll: need a contiguous torch.float32"),
    ("active_int32", "active: need a contiguous torch.int64"),
    ("it_pass_int64", "it_pass: need a contiguous torch.int32"),
    ("it_total_shape", r"it_total: shape \(1,\) != \(\)"),
])
def test_update_check_raises(case, match):
    x, c, s, ll = _checks()
    pools, lstar, active = x.pools, x.lstar, None
    if case == "pools_shape":
        pools = pools[:, :, :4].contiguous()
    elif case == "lstar_flat":
        lstar = lstar.reshape(Q)
    elif case == "ll_double":
        ll = ll.double()
    elif case == "active_int32":
        active = torch.zeros((Q, B), dtype=torch.int32)
    elif case == "it_pass_int64":
        c = c._replace(it_pass=c.it_pass.long())
    elif case == "it_total_shape":
        c = c._replace(it_total=c.it_total.reshape(1))
    with pytest.raises(ValueError, match=match):
        slice_cuda._check_update(**_update(c, pools, lstar, ll, s, active))
