"""The correctness check's control, and the readings its limits are set from.

``python3 benchmark/control.py --workload NAME --seeds A,B,C [--seconds S]``
runs the cell's set-up and a short window (``--seconds``: one fit at the
cell's own size by default) for each seed in one process, and prints per
seed one JSON line: the numbers the check compares for the program's
outputs, and the same numbers for the control, which is the plain
reference put in the program's place at the next precision below the
configuration's float32 (TF32 operands in the line-spread convolution,
bfloat16 in the weights, the evidence and the prior transform; see
:mod:`benchmark.check`).  The last line sums them up: the largest program
reading and the smallest control reading of each number, and whether the
control failed a limit on every seed.  The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from argparse import Namespace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload, seeds, seconds=1.0, device="cuda", extra=None, seeds_per_fit=None,
             with_control=True):
    """Per seed: the program's numbers, the control's (None without
    ``with_control``), and the cell's limits."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmark"))
    import os

    import run

    for k, v in run.CACHES.items():
        os.environ[k] = str(v)
    out = []
    for seed in seeds:
        res = run.measure(Namespace(workload=workload, seed=int(seed), seconds=seconds, trace=0),
                          device=device, extra=extra, seeds_per_fit=seeds_per_fit,
                          t0=time.perf_counter(), with_control=with_control)
        out.append({"seed": int(seed), "correct": res["correct"],
                    "program": {k: c["value"] for k, c in res["checks"].items()},
                    "control": res.get("control"),
                    "limits": {k: c["limit"] for k, c in res["checks"].items()},
                    "fits": res["attempted"]})
    return out


def control_fails(reading) -> bool:
    """The control breaks at least one of the cell's limits."""
    return any(reading["control"][k] > lim for k, lim in reading["limits"].items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds)
    for r in rows:
        print(json.dumps(r), flush=True)
    keys = rows[0]["program"].keys()
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows) for k in keys},
        "control_min": {k: min(r["control"][k] for r in rows) for k in keys},
        "program_correct_all": all(r["correct"] for r in rows),
        "control_fails_all": all(control_fails(r) for r in rows),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
