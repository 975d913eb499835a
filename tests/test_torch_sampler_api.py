"""The JAX package's last public sampler names in the port: ``make_sampler``,
``nested_sample_device`` and ``warmup_executables``, and the check that
every public name of ``mcalf_tpu`` has a counterpart in ``mcalf_torch``.

* ``make_sampler(ll, cfg)(gen)`` is ``nested_sample`` with that generator,
  byte for byte;
* ``nested_sample_device``: the JAX package's fixed budget of outer steps
  and no re-clustering; a member of its stacked form is its solo run bit
  for bit (the evidence over 24 seeds, the twin of
  tests/test_sampler.py::test_evidence_unbiased_over_seeds for it, is in
  tests/test_torch_evidence_seeds.py);
* ``warmup_executables`` leaves the caller's generator where it was, and a
  fit after it is the fit without it, byte for byte (the card's contract,
  no build or geometry after it, is in tests/test_torch_graph_gpu.py);
* tools/torch_warm_cache.py runs on the CPU.
"""

import ast
import math
import sys
from pathlib import Path

import pytest
import torch

import mcalf_tpu.sampler as jsampler
import mcalf_torch.sampler as tsampler
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.sampler import (
    NSConfig,
    make_sampler,
    nested_sample,
    nested_sample_device,
    warmup_executables,
)
from mcalf_torch.sampler import nested as tn

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"


def _gauss(ndim=4, sigma=0.08):
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def loglike(u):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(torch.float32)

    return loglike


def _anchor():
    m = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 1), specres=[8.0],
        Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )
    return m, make_torch_forward(m, "cpu").loglike_cube


def _same_results(a, b):
    for k, x in a._asdict().items():
        y = getattr(b, k)
        if torch.is_tensor(x):
            assert torch.equal(x, y), k
        else:
            assert x == y, k


#: public names of the JAX package and the port's name for each where it
#: differs (ROADMAP Queue 1): the JAX forward model and its Pallas
#: kernels' entry points, and host helpers the port needs no copy of
COUNTERPARTS = {
    "JaxForward": "TorchForward",
    "make_jax_forward": "make_torch_forward",
    "resolve_use_pallas": "make_torch_forward",  # the device picks kernel or plain
    "likelihood_pallas": "fused_loglike",
    "voigt_tau_pallas": "voigt_tau",
    "window_offsets": "fused_loglike",  # the kernel's per-pixel window branch
    "pallas_supported": "check_supported",
    "enable_compile_cache": "load",  # ops/_build.py's on-disk library cache
    "native_available": "read_spectrum_table",  # io/ reads and writes with numpy
    "read_table": "read_spectrum_table",
    "write_table": "write_equal_weights",
}


def _top_level_names(root: Path) -> set:
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


def test_every_public_jax_name_has_a_counterpart():
    jax_names = {n for n in _top_level_names(REPO / "mcalf_tpu") if not n.startswith("_")}
    port = _top_level_names(REPO / "mcalf_torch")
    missing = sorted(n for n in jax_names if COUNTERPARTS.get(n, n) not in port)
    assert not missing, missing
    # the map names only what the port really lacks under the JAX name
    assert all(n in jax_names and n not in port for n in COUNTERPARTS)


def test_sampler_exports_every_jax_sampler_name():
    assert set(jsampler.__all__) <= set(tsampler.__all__)
    for name in ("make_sampler", "nested_sample_device", "warmup_executables"):
        assert name in tn.__all__ and getattr(tsampler, name) is getattr(tn, name)


def test_make_sampler_is_nested_sample():
    cfg = NSConfig(ndim=4, nlive=60, num_delete=20, max_samples=3000)
    run = make_sampler(_gauss(), cfg)
    a = run(torch.Generator().manual_seed(11))
    b = nested_sample(_gauss(), torch.Generator().manual_seed(11), cfg, "cpu")
    assert a.termination_reason == 0 and a.samples_u.device.type == "cpu"
    _same_results(a, b)


def test_nested_sample_device_budget_and_no_reclustering(monkeypatch):
    """The JAX function's steps: init_state, at most max_samples //
    num_delete + 2 outer steps, finalize; never a re-clustering (the live
    set keeps cluster 0).  The budget binds before termination here."""
    def no_recluster(*a, **k):
        raise AssertionError("nested_sample_device re-clustered")

    monkeypatch.setattr(tn, "_recluster", no_recluster)
    cfg = NSConfig(ndim=4, nlive=60, num_delete=20, max_samples=400)
    res = nested_sample_device(_gauss(), torch.Generator().manual_seed(2), cfg, "cpu")
    assert res.n_iter == 400 // 20 and res.termination_reason == 1
    with pytest.raises(AssertionError, match="re-clustered"):
        nested_sample(_gauss(), torch.Generator().manual_seed(2), cfg, "cpu")
    # the solo run is run_steps from init_state, finalized
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(2)
    state = tn.init_state(_gauss(), gen, cfg, "cpu")
    state = tn.run_steps(_gauss(), state, cfg, 400 // 20 + 2, gen)
    _same_results(res, tn.finalize(state, cfg))


def test_nested_sample_device_members_are_solo_runs():
    """Three seeds of the 1-comp anchor through the stacked form, the
    fleet's likelihood (StackedForward): each is its solo run bit for bit,
    though they stop at different steps."""
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward

    m, ll = _anchor()
    rows = make_stacked_forward(*stack_problems([m] * 3), "cpu").loglike_cube
    cfg = NSConfig(ndim=m.ndim, nlive=40, num_repeats=6, max_samples=1600)
    finals = tn._nested_sample_device_stacked(
        rows, [torch.Generator().manual_seed(s) for s in (1, 2, 3)], cfg, "cpu")
    assert len({f.step for f in finals}) > 1
    for s, f in zip((1, 2, 3), finals):
        _same_results(tn.finalize(f, cfg),
                      nested_sample_device(ll, torch.Generator().manual_seed(s), cfg, "cpu"))


def test_warmup_leaves_the_generator_and_the_fit_unchanged():
    m, ll = _anchor()
    cfg = NSConfig(ndim=m.ndim, nlive=40, num_repeats=8, max_samples=600,
                   canon_layout=m.canon_layout())
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state().clone()
    warmup_executables(ll, gen, cfg, "cpu")
    assert torch.equal(gen.get_state(), start)
    warm = nested_sample(ll, gen, cfg, "cpu")
    cold = nested_sample(ll, torch.Generator().manual_seed(5), cfg, "cpu")
    assert warm.n_like > cfg.nlive
    _same_results(warm, cold)


def test_warm_cache_tool_runs_on_the_cpu(capsys):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import torch_warm_cache
    finally:
        sys.path.pop(0)
    out = torch_warm_cache.main(["--device", "cpu", "--workloads", "anchor"])
    assert out["device"] == "cpu"
    [r] = out["workloads"]
    assert r["workload"] == "anchor" and r["ndim"] == 4
    assert r["build_s"] == 0.0 and r["captures"] == 0 and r["warmup_s"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("{") and "anchor (ndim 4" in lines[-2]
    with pytest.raises(SystemExit):
        torch_warm_cache.main(["--device", "cpu", "--workloads", "nope"])
