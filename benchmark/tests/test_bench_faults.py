"""The harness's run with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have (a one-chip cell has no
exchange between chips to leave out), and true for the sound program.  On
the CPU at a size a test run holds; with the ``gpu`` mark at each cell's
own size on the card (``python -m pytest -m gpu -s
benchmark/tests/test_bench_faults.py``, which prints each reading)."""

import json

import numpy as np
import pytest
import torch

from _common import ROOT, tiny_run

from benchmark import control

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**33 + 201, 2**33 + 202, 2**33 + 203)


def _state_unchanged(monkeypatch):
    """The outer step keeps its live set: the deletions are booked, the
    replacements never enter."""
    from mcalf_torch.sampler import nested

    def tail(s, h, u_new, logl_new, n_evals, cfg, gen):
        B = cfg.num_delete
        return s._replace(dead_u=h.dead_u, dead_logl=h.dead_logl, dead_logw=h.dead_logw,
                          dead_birth=h.dead_birth, n_dead=s.n_dead + B, logx=h.logx,
                          logz=h.logz, n_like=s.n_like + n_evals, step=s.step + 1)

    monkeypatch.setattr(nested, "_tail", tail)


def _on_both_forwards(monkeypatch, broken):
    """Put ``broken(orig)`` in place of the likelihood of a fleet's stacked
    rows (``StackedForward.loglike_cube(u, prob)``) and of a one-seed fit's
    rows (``TorchForward.loglike_cube(u)``)."""
    from mcalf_torch.models.torch_model import StackedForward, TorchForward

    for cls in (StackedForward, TorchForward):
        monkeypatch.setattr(cls, "loglike_cube", broken(cls.loglike_cube))


def _half_batch(monkeypatch):
    """The likelihood evaluates the first half of each batch and gives the
    rest the mean of that half."""

    def broken(orig):
        def half(self, u, *prob):
            n = max(1, u.shape[0] // 2)
            first = orig(self, u[:n], *(p[:n] for p in prob))
            return torch.cat([first, first.mean().expand(u.shape[0] - n)])

        return half

    _on_both_forwards(monkeypatch, broken)


def _logl_altered(monkeypatch):
    """Each likelihood call hands its answers to the wrong rows, as a
    misindexed output would: row i gets row i+1's log L."""
    _on_both_forwards(monkeypatch, lambda orig: (
        lambda self, u, *prob: torch.roll(orig(self, u, *prob), -1)))


def _evidence_altered(monkeypatch):
    """Each run's log Z comes out 1 nat high where the sampler produces it
    (0.1 nat at a capped flagship fit's |log Z| of 1e4 to 1e5 lies inside
    the port's own bar, 0.05 + 1e-5 |log Z|)."""
    from mcalf_torch.parallel import fleet
    from mcalf_torch.sampler import nested

    orig = nested.finalize

    def finalize(final, config):
        res = orig(final, config)
        return res._replace(logz=res.logz + 1.0)

    monkeypatch.setattr(nested, "finalize", finalize)
    monkeypatch.setattr(fleet, "finalize", finalize)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "logl_altered": _logl_altered, "evidence_altered": _evidence_altered}


def test_the_sound_program_is_correct():
    out = tiny_run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_correct_false(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = tiny_run()
    assert not out["correct"], out["checks"]
    broken = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert broken and np.all([np.isfinite(c["limit"]) for c in out["checks"].values()])


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_makes_correct_false_at_the_cells_size(workload, fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    FAULTS[fault](monkeypatch)
    rows = control.readings(workload, SEEDS, seconds=1.0, with_control=False)
    print("fault readings " + json.dumps({"workload": workload, "fault": fault, "rows": [
        {"seed": r["seed"], "correct": r["correct"], "fits": r["fits"], "program": r["program"]}
        for r in rows]}), flush=True)
    for r in rows:
        assert not r["correct"], r["program"]
