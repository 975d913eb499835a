"""A cell whose fits resume from a checkpoint (traffic ``resume_at``): the
set-up's checkpoint is the fitter's own, a resumed fit counts only what it
added and writes the files of the fit it continues, ``resume_breaks``
sees a fit that did not continue the checkpoint, each fault of the timed
path makes such a run incorrect, and the new seed role moves no other
role's seeds.  On the CPU at TINY's size; with the ``gpu`` mark at the
cell's own size on the card (``python -m pytest -m gpu -s
benchmark/tests/test_bench_resume.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _common import RESUMED, TINY_RESUME_AT, TINY_RESUMED, tiny_resumed_run
from test_bench_faults import FAULTS

from benchmark import control, harness

SEED = 2**33 + 301


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A checkpoint of the cell at TINY's size, one fit resumed from it and
    the uninterrupted fit of the same seed and cap."""
    cell = harness.Cell(RESUMED[0])
    cell.resume_at = TINY_RESUME_AT
    extra = dict(TINY_RESUMED, **{"run.device": "cpu"})
    bench = harness.Bench(cell, tmp_path_factory.mktemp("resumed"))
    resume = bench.checkpoint(harness.fit_seeds(SEED, "resume", 0, 1)[0], extra)
    rec = bench.fit(0, [resume.seed], None, extra)
    bench.resume = None
    whole = bench.fit(1, [resume.seed], None, extra)
    return resume, rec, whole


def test_the_checkpoint_is_the_fitters_own_at_resume_at(resumed):
    from mcalf_torch.utils.checkpoint import latest_checkpoint, load_state

    resume, _, _ = resumed
    path = latest_checkpoint(str(resume.directory))
    assert Path(path).name == "ns_state_000008.npz"  # the 8-step probe's end
    state = load_state(path, device="cpu")
    assert state.n_dead == resume.n_dead == TINY_RESUME_AT and state.rng is not None
    assert resume.dead_u.shape == (TINY_RESUME_AT, state.dead_u.shape[1])


def test_a_resumed_fit_counts_only_what_it_added(resumed):
    resume, rec, whole = resumed
    assert rec.error is None and whole.error is None
    [run] = rec.runs
    assert rec.dead == 10 and whole.dead == 50
    assert rec.n_like == int(run.n_like) - resume.n_like > 0
    assert whole.n_like == int(whole.runs[0].n_like) == int(run.n_like)


def test_a_resumed_fit_writes_the_uninterrupted_fits_files(resumed):
    _, rec, whole = resumed
    for suffix in (".stats", "_equal_weights.txt"):
        got = Path(rec.base + suffix).read_bytes()
        assert got and got == Path(whole.base + suffix).read_bytes(), suffix


def _fresh_start(monkeypatch):
    """The fit ignores ``[run] checkpoint`` and ``[run] seed``, as a reader
    of the .cfg that drops them would, and starts afresh at the default
    seed.  (Afresh at the checkpoint's own seed a fit rewrites the
    checkpoint's rows bit for bit: right, and only slower.)"""
    from mcalf_torch import cli

    read = cli.readconfig

    def dropping(path):
        pars = read(path)
        pars.pop("checkpoint", None)
        pars.pop("seed", None)
        return pars

    monkeypatch.setattr(cli, "readconfig", dropping)


def test_resume_breaks_reads_nought_in_a_sound_run():
    out = tiny_resumed_run()
    assert out["correct"], out["checks"]
    assert out["checks"]["resume_breaks"] == {"value": 0.0, "limit": 0.0}


def test_a_checkpoint_never_made_makes_the_run_incorrect():
    """A fit that meets no chunk boundary at ``resume_at`` (here: one that
    is not a boundary) fails the run's set-up: ``correct`` false, not a
    crash."""
    out = tiny_resumed_run(resume_at=TINY_RESUME_AT + 5)
    assert not out["correct"] and out["failed"] == 1
    assert out["checks"] == {"failed_fits": {"value": 1.0, "limit": 0.0}}


@pytest.mark.parametrize("fault", ["fresh_start"] + sorted(FAULTS))
def test_a_fault_makes_a_resumed_run_incorrect(fault, monkeypatch):
    (_fresh_start if fault == "fresh_start" else FAULTS[fault])(monkeypatch)
    out = tiny_resumed_run()
    assert not out["correct"], out["checks"]
    if fault == "fresh_start":
        assert out["checks"]["resume_breaks"]["value"] > 0, out["checks"]


def test_the_resume_role_moves_no_other_roles_seeds():
    """Each role's seeds come from its index in ``ROLES``: the roles before
    the resume role keep theirs (values of the harness before it)."""
    assert harness.ROLES[:3] == ("window", "warm-up", "profiled")
    assert harness.ROLES[-1] == "resume"
    assert harness.fit_seeds(2**33 + 5, "window", 3, 2) == [3851966955, 126411843]
    assert harness.fit_seeds(2**33 + 5, "warm-up", 0, 1) == [1070606992]
    assert harness.fit_seeds(2**33 + 5, "profiled", 0, 1) == [3686023073]
    resume = harness.fit_seeds(2**33 + 5, "resume", 0, 1)
    assert resume != harness.fit_seeds(2**33 + 5, "window", 0, 1)
    assert resume == [int(np.random.SeedSequence([2**33 + 5, 3, 0]).generate_state(1, np.uint32)[0])]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", RESUMED)
def test_a_fresh_start_breaks_resume_at_the_cells_size(workload, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _fresh_start(monkeypatch)
    rows = control.readings(workload, (2**33 + 211, 2**33 + 212, 2**33 + 213), seconds=1.0,
                            with_control=False)
    print("fault readings " + json.dumps({"workload": workload, "fault": "fresh_start", "rows": [
        {"seed": r["seed"], "correct": r["correct"], "fits": r["fits"], "program": r["program"]}
        for r in rows]}), flush=True)
    for r in rows:
        assert not r["correct"] and r["program"]["resume_breaks"] > 0, r["program"]
