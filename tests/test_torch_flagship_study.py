"""tools/torch_flagship_study.py, the port's flagship evidence study,
against the JAX package's tools/flagship_study.py: the same jobs in every
mode, grouped into fleets; one short fleet on the CPU for the records'
shape (the JAX record's keys and the fleet's size); the fixed-k
decomposition Z = logsumexp(Z8, Z9, Z10) - ln 3 on made-up records."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parents[1] / "tools"))

import flagship_study as jstudy  # noqa: E402
import torch_flagship_study as tstudy  # noqa: E402

MODES = ("full", "anchor544", "recal", "fixedk544")
#: the keys of the JAX script's records (tools/flagship_study_r03.jsonl)
JAX_KEYS = ["tag", "ncomp", "ndim", "num_repeats", "num_delete", "seed", "logz", "logzerr",
            "h", "n_like", "n_dead", "rank_p", "rank_p_blocks", "converged", "wall_s"]


@pytest.mark.parametrize("mode", MODES)
def test_jobs_are_the_jax_scripts(mode):
    jobs = tstudy.build_jobs(mode)
    assert jobs == jstudy.build_jobs(mode)
    groups = tstudy.fleets(jobs)
    assert sorted(j for g in groups for j in g) == sorted(jobs)
    for g in groups:
        assert len({(j[1], j[2], j[3]) for j in g}) == 1
    if mode == "fixedk544":
        assert [len(g) for g in groups] == [2, 2, 2]


def test_models_are_the_jax_scripts():
    for ncomp in ((8, 11), (9, 9)):
        a, b = jstudy.make_model(ncomp), tstudy.make_model(ncomp)
        assert (a.ndim, a.canon_layout()) == (b.ndim, b.canon_layout())
        np.testing.assert_array_equal(a.obj, b.obj)
        np.testing.assert_array_equal(a.bounds_lo, b.bounds_lo)


def test_one_short_fleet_writes_the_jax_records(tmp_path, monkeypatch):
    """Two fixed-k jobs as one fleet, cut short (nlive 20, 2 repeats, 40
    samples)."""
    import dataclasses

    monkeypatch.setattr(tstudy, "build_jobs", lambda mode: [
        ("fixedk544_8", (8, 8), 544, 100, 63), ("fixedk544_8", (8, 8), 544, 100, 64)])
    config = tstudy.config
    monkeypatch.setattr(tstudy, "config", lambda *a: dataclasses.replace(
        config(*a), nlive=20, num_delete=10, max_samples=40, num_repeats=2))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = tmp_path / "study.jsonl"
    try:
        summary = tstudy.main(str(out), "fixedk544", "cpu", log=lambda *a: None)
    finally:
        torch.set_num_threads(n)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["seed"] for r in recs] == [63, 64]
    for r in recs:
        assert list(r) == JAX_KEYS + ["fleet"]
        assert r["fleet"] == 2 and r["ncomp"] == [8, 8] and r["num_repeats"] == 2
        assert math.isfinite(r["logz"]) and r["n_like"] > 0
    assert summary["ks"] == [8] and summary["seeds"] == [63, 64]


def test_decomposition():
    recs = [{"seed": s, "ncomp": [k, k], "logz": z}
            for s, zs in ((63, (4850.0, 4855.0, 4852.0)), (64, (4851.0, 4856.0, 4853.0)))
            for k, z in zip((8, 9, 10), zs)]
    d = tstudy.decompose(recs)
    lse = lambda a: max(a) + math.log(sum(math.exp(x - max(a)) for x in a))
    assert d["ks"] == [8, 9, 10] and d["seeds"] == [63, 64]
    assert math.isclose(d["per_seed"]["63"]["logz"], lse([4850.0, 4855.0, 4852.0]) - math.log(3))
    t = d["together"]
    assert t["logz_k"] == [4850.5, 4855.5, 4852.5]
    assert math.isclose(t["logz"], lse(t["logz_k"]) - math.log(3))
    assert math.isclose(t["tol_ladder"], 2 * math.hypot(1.33 / math.sqrt(2), 0.44))
    assert math.isclose(t["d_ladder"], t["logz"] - 4855.03)
    assert math.isclose(t["d_port_merged"], t["logz"] - 4855.983)
    assert t["ok_ladder"] == (abs(t["d_ladder"]) < t["tol_ladder"])
