"""Shared set-up of the benchmark's CPU tests: the repository root on the
path, and a tiny CPU run of a cell (the harness's own path with the chip
look skipped)."""

import json
import sys
import time
from argparse import Namespace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "benchmark")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the .cfg of every configuration of BENCHMARK.json, and the repository's
#: HI-forest fit (a filler line beside the fitted ones), which no cell runs,
#: as a second model for the reference and the count
CFGS = sorted({json.loads((ROOT / c["file"]).read_text())["cfg"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]} | {"testdata/hi_forest.cfg"})
#: the cell the CPU tests run at a tiny size
WORKLOAD = "civ-flagship.seeds8"
#: a run small enough for the CPU: the flagship's model and spectrum with
#: two seeds a fit, 10 live points, two outer steps of fits, few slice
#: repeats
TINY = {"jaxns_settings.max_samples": "10", "ns_settings.nlive": "10",
        "ns_settings.num_repeats": "6"}
#: the cells whose traffic resumes every fit from a checkpoint
RESUMED = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
           if "resume_at" in json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())]
#: a resumed cell at TINY's size: the checkpoint at its first chunk boundary
#: (8 outer steps of 5 dead points), then 10 dead points a fit
TINY_RESUME_AT = 40
TINY_RESUMED = dict(TINY, **{"jaxns_settings.max_samples": "50"})


def tiny_run(seed: int = 2**33 + 5, with_control: bool = False, trace: int = 0) -> dict:
    import run

    return run.measure(Namespace(workload=WORKLOAD, seed=seed, seconds=0.0, trace=trace),
                       device="cpu", extra=TINY, seeds_per_fit=2, t0=time.perf_counter(),
                       with_control=with_control)


def tiny_resumed_run(seed: int = 2**33 + 9, resume_at: int = TINY_RESUME_AT) -> dict:
    import run

    return run.measure(Namespace(workload=RESUMED[0], seed=seed, seconds=0.0, trace=0),
                       device="cpu", extra=TINY_RESUMED, t0=time.perf_counter(),
                       resume_at=resume_at)
