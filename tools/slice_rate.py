"""Likelihood evaluations per second of chip_smoke.py's slice cells, for
any checkout of the port.

    python3 tools/slice_rate.py [--root DIR] [--repeats N]

Imports ``mcalf_torch`` from DIR (default: this checkout) and runs
chip_smoke.py's phase 6 with this checkout's chip_smoke.py: the flagship
slice (testdata/fit.cfg at full width, 10 outer steps, 544 repeats) and the
narrow flagship's, N times each, through ``mcalf_torch.cli.main`` on one
CUDA card.  The rate drifts with the host's load (an eager sampler loop's
far more than a captured one's), so compare two checkouts by running this for each in
turns, one after the other on the same card.  Prints chip_smoke.py's slice lines and
a JSON line with every rate.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose mcalf_torch runs")
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    smi = smoke.phase_device()
    smoke.phase_build()
    tmp = root / "build" / "slice_rate"
    rates = {"root": str(root), "card": smi, "flagship": [], "narrow": []}
    for _ in range(args.repeats):
        for name, brange in (("flagship", None), ("narrow", "3.0, 40.0")):
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            try:
                res = smoke.phase_slice(tmp, name, brange=brange)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            rates[name].append(res["n_like"] / res["wall"])
    print(json.dumps(rates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
