"""The benchmark as data: every cell of BENCHMARK.json resolves its files
by name, keeps the naming rules, and a new cell needs only new files."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from _common import ROOT

from benchmark import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert word.split("/")[0] in BENCH["paths"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_the_rules(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        if section == "end_to_end":
            assert 0 < e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.cfg_source.is_file() and (ROOT / cell.config["spectrum"]).is_file()
    assert cell.datadir == (ROOT / cell.config["spectrum"]).parent
    [entry] = [c for c in BENCH["configs"] if c["name"] == cell.workload["config"]]
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert set(entry["reduced"]) == set(cell.config["reduced"])
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.chips == 1


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            reports = e2e[m["moves"]].get("workloads", cells)
            assert w in reports, (m["name"], w)


def test_a_new_cell_takes_new_files_only(tmp_path, monkeypatch):
    """A traffic mix, a metric and a cell added as files and entries: the
    harness finds them with no edit of its code."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark")
    (copy / "benchmark" / "traffic" / "seeds3.json").write_text(json.dumps(
        {"name": "seeds3", "seeds_per_fit": 3, "bracket": "chord"}))
    (copy / "benchmark" / "metrics" / "fits_run.py").write_text(
        "def read(rec):\n    return rec['fits']\n")
    [first] = BENCH["workloads"][:1]
    name = f"{first['config']}.seeds3"
    shutil.copy(copy / "benchmark" / "limits" / f"{first['name']}.json",
                copy / "benchmark" / "limits" / f"{name}.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": first["config"],
                               "traffic": "seeds3", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "fits_run", "unit": "fits", "better": "higher",
                               "source": "host_clock", "layer": "runner and outputs",
                               "moves": "dead_points_per_s", "workloads": [name]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{first['config']}.json").read_text())
    for rel in (cfg["cfg"], cfg["spectrum"]):
        (copy / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, copy / rel)
    monkeypatch.setattr(harness, "ROOT", copy)
    monkeypatch.setattr(harness, "HERE", copy / "benchmark")
    cell = harness.Cell(name)
    assert cell.seeds_per_fit == 3
    assert [m["name"] for m in cell.per_layer] == ["fits_run"]
    assert harness.metric_reader("fits_run")({"fits": 4}) == 4
    cfg = cell.write_cfg(tmp_path / "fit", [1, 2, 3])
    assert "seeds = 1,2,3" in cfg.read_text()


def test_a_changed_source_file_is_refused(tmp_path, monkeypatch):
    """A configuration reads its .cfg and spectrum only with the bytes it
    pins."""
    [entry] = BENCH["configs"][:1]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    copy = tmp_path / "repo"
    for rel in (cfg["cfg"], cfg["spectrum"]):
        (copy / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, copy / rel)
    monkeypatch.setattr(harness, "ROOT", copy)
    workload = next(w["name"] for w in BENCH["workloads"] if w["config"] == entry["name"])
    assert harness.Cell(workload, BENCH).cfg_source == copy / cfg["cfg"]
    for rel in (cfg["cfg"], cfg["spectrum"]):
        saved = (copy / rel).read_bytes()
        (copy / rel).write_bytes(saved + b"\n")
        with pytest.raises(ValueError, match="has changed"):
            harness.Cell(workload, BENCH)
        (copy / rel).write_bytes(saved)


def test_run_names_no_workload_or_cell_in_its_code():
    """run.py and the harness hold no cell, configuration or traffic name."""
    names = [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for f in ("run.py", "harness.py", "check.py", "trace.py", "work.py"):
        text = (ROOT / "benchmark" / f).read_text()
        assert not [n for n in names if n in text], f


def test_run_refuses_without_a_card():
    """On a machine with no CUDA card run.py names why and prints no result;
    it does not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = dict(os.environ)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
                        "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert "no CUDA device" in p.stderr
    assert p.stdout.strip() == ""


def test_harness_code_imports_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert not tops & {"jax", "jaxlib", "flax", "mcalf_tpu"}, path
