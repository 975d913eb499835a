"""The slice loop as replays of a captured CUDA graph, on a card, against
the eager loop (``_loop="eager"``).  Marked ``gpu``: they skip without a
CUDA device.  No jax here, so on a machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py

* captured = eager bit for bit (samples, log L, logZ, evaluations, the
  generator's state at every chunk boundary) on a small Gaussian and on the
  1-comp CIV anchor;
* a fleet member is its solo run, both captured;
* the likelihood in conv_mode='wrap' (the tau kernel), solo and as a
  fleet, captured = eager;
* fused-kernel launches counted by replay equal the fused kernel's runs
  in a profiler trace; evaluations come from the device counter;
* a likelihood that reads the device cannot be captured: the capture
  raises, naming it.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.ops import voigt_cuda
from mcalf_torch.sampler import NSConfig, nested_sample
from mcalf_torch.sampler import graph
from mcalf_torch.sampler import nested as tn
from mcalf_torch.utils.profiling import trace

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"
_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], specres=[8.0],
    Nrange=[12.0, 14.5], zrange=[2.99, 3.01], brange=[10.0, 40.0],
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gauss(cuda):
    mu = torch.linspace(0.3, 0.7, 6, device=cuda)

    def loglike(u):
        return -0.5 * torch.sum(((u - mu) / 0.05) ** 2, dim=-1)

    return loglike


def _anchor(cuda):
    m = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec.txt"), ncomp=(1, 1), **_CIV)
    return m, make_torch_forward(m, cuda).loglike_cube


def _run(loglike, cfg, cuda, loop, seed=7):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rngs = []
    res = nested_sample(loglike, gen, cfg, cuda, chunk_steps=4,
                        on_chunk=lambda s: rngs.append(s.rng), _loop=loop)
    return res, rngs, gen.get_state()


def _same(a, b):
    (ra, rngs_a, end_a), (rb, rngs_b, end_b) = a, b
    assert float(ra.logz) == float(rb.logz)
    assert (ra.n_like, ra.n_iter) == (rb.n_like, rb.n_iter)
    for k in ("samples_u", "logl", "logw", "birth_logl", "insertion_rank"):
        assert torch.equal(getattr(ra, k), getattr(rb, k)), k
    assert len(rngs_a) == len(rngs_b) > 1
    assert all(torch.equal(x, y) for x, y in zip(rngs_a, rngs_b))
    assert torch.equal(end_a, end_b)


@pytest.mark.parametrize("k", (7, 32))
def test_captured_equals_eager_gaussian(cuda, k, monkeypatch):
    monkeypatch.setattr(tn, "BLOCK_ITERATIONS", k)
    cfg = NSConfig(ndim=6, nlive=50, num_repeats=12, max_samples=1500)
    graph.reset_stats()
    captured = _run(_gauss(cuda), cfg, cuda, None)
    assert graph.stats["captures"] == 1 and graph.stats["replays"] > 0
    _same(captured, _run(_gauss(cuda), cfg, cuda, "eager"))


def test_captured_equals_eager_anchor(cuda):
    m, loglike = _anchor(cuda)
    cfg = NSConfig(ndim=m.ndim, nlive=40, num_repeats=8, max_samples=1200,
                   canon_layout=m.canon_layout())
    _same(_run(loglike, cfg, cuda, None), _run(loglike, cfg, cuda, "eager"))


def test_launches_count_replays(cuda, tmp_path):
    m, loglike = _anchor(cuda)
    cfg = NSConfig(ndim=m.ndim, nlive=40, num_repeats=8, max_samples=800)
    graph.reset_stats()
    voigt_cuda.launches = 0
    with trace(str(tmp_path)):
        res = nested_sample(loglike, torch.Generator(device=cuda).manual_seed(3), cfg, cuda)
    # the initial live set, one warm-up iteration, and k per replay
    assert graph.stats["warmups"] == graph.stats["captures"] == 1
    assert voigt_cuda.launches == 1 + 1 + graph.stats["iterations"]
    assert graph.stats["iterations"] == graph.stats["replays"] * tn.BLOCK_ITERATIONS
    B = cfg.resolved().num_delete
    assert res.n_like - cfg.nlive <= B * graph.stats["iterations"]
    # what the card ran: the fused kernel's runs in the trace
    [path] = tmp_path.glob("*.json")
    runs = sum(1 for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel" and "fused_loglike_kernel" in e.get("name", ""))
    assert runs == voigt_cuda.launches


def test_member_is_solo_captured(cuda):
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.parallel import fit_stacked
    from mcalf_torch.sampler.nested import unstack_results

    m, loglike = _anchor(cuda)
    cfg = NSConfig(ndim=m.ndim, nlive=40, num_repeats=6, max_samples=2000)
    seeds = (1, 2, 3)
    graph.reset_stats()
    gens = [torch.Generator(device=cuda).manual_seed(s) for s in seeds]
    res = fit_stacked(*stack_problems([m] * 3), cfg, mesh=[cuda], generators=gens)
    assert graph.stats["captures"] >= 1
    members = unstack_results(res)
    assert len({r.n_iter for r in members}) > 1  # they leave the stack at different steps
    for s, member, g in zip(seeds, members, gens):
        solo_gen = torch.Generator(device=cuda).manual_seed(s)
        one = nested_sample(loglike, solo_gen, cfg, cuda)
        assert float(member.logz) == float(one.logz) and member.n_like == one.n_like
        assert torch.equal(member.samples_u, one.samples_u)
        assert torch.equal(member.logl, one.logl)
        assert torch.equal(g.get_state(), solo_gen.get_state())


def test_captured_equals_eager_wrap(cuda):
    """The likelihood in conv_mode='wrap' (voigt_tau, exp, the circular
    LSF, the chi^2 sum) inside the captured loop: captured = eager bit for
    bit, one tau launch and no fused launch per likelihood call run."""
    m = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec.txt"), ncomp=(1, 1), **_CIV)
    loglike = make_torch_forward(m, cuda, conv_mode="wrap").loglike_cube
    cfg = NSConfig(ndim=m.ndim, nlive=40, num_repeats=8, max_samples=1200,
                   canon_layout=m.canon_layout())
    graph.reset_stats()
    voigt_cuda.launches = voigt_cuda.tau_launches = 0
    captured = _run(loglike, cfg, cuda, None)
    assert voigt_cuda.launches == 0 and graph.stats["captures"] >= 1
    # the initial live set, one warm-up iteration per capture, k per replay
    assert voigt_cuda.tau_launches == 1 + graph.stats["warmups"] + graph.stats["iterations"]
    _same(captured, _run(loglike, cfg, cuda, "eager"))


def test_wrap_fleet_captured_equals_eager(cuda):
    """Three stacked problems in conv_mode='wrap' (two seeds of one
    spectrum and another spectrum): the captured fleet is the eager one bit
    for bit, one tau launch per stacked likelihood call."""
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward
    from mcalf_torch.sampler import finalize

    models = [AbsorptionModel.from_file(str(TESTDATA / f), ncomp=(1, 1), **_CIV)
              for f in ("civ_mock_spec.txt", "civ_mock_spec.txt", "civ_mock_spec_multicomp.txt")]
    fwd = make_stacked_forward(*stack_problems(models, conv_mode="wrap"), cuda)
    cfg = NSConfig(ndim=4, nlive=40, num_repeats=6, max_samples=1200)
    calls = [0]

    def rows(u, prob):
        calls[0] += 1
        return fwd.loglike_cube(u, prob)

    out = {}
    for loop in (None, "eager"):
        gens = [torch.Generator(device=cuda).manual_seed(s) for s in (1, 2, 1)]
        voigt_cuda.launches = voigt_cuda.tau_launches = 0
        ll = rows if loop == "eager" else fwd.loglike_cube
        finals = tn.nested_sample_stacked(ll, gens, cfg, cuda, _loop=loop)
        out[loop] = ([finalize(f, cfg) for f in finals], voigt_cuda.tau_launches,
                     voigt_cuda.launches)
    (cap, _, cap_fused), (eag, eag_tau, _) = out[None], out["eager"]
    assert cap_fused == 0 and eag_tau == calls[0]
    for a, b in zip(cap, eag):
        assert float(a.logz) == float(b.logz) and a.n_like == b.n_like
        assert torch.equal(a.samples_u, b.samples_u) and torch.equal(a.logl, b.logl)


def test_uncapturable_likelihood_raises(cuda):
    """In a process of its own: a failed capture leaves the capture stream's
    allocator state behind."""
    code = textwrap.dedent("""
        import torch
        from mcalf_torch.sampler import NSConfig, nested_sample

        mu = torch.linspace(0.3, 0.7, 6, device="cuda")

        def reads_the_device(u):
            ll = -0.5 * torch.sum(((u - mu) / 0.05) ** 2, dim=-1)
            if bool(torch.isnan(ll).any()):  # a host read: not capturable
                raise ValueError("nan")
            return ll

        cfg = NSConfig(ndim=6, nlive=20, num_repeats=4, max_samples=200)
        try:
            nested_sample(reads_the_device, torch.Generator(device="cuda").manual_seed(1),
                          cfg, "cuda")
        except RuntimeError as e:
            print("RAISED", e)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RAISED the likelihood " in proc.stdout
    assert "reads_the_device cannot be captured in a CUDA graph" in proc.stdout
