"""The captured slice loop's block size k against its cost, on one CUDA card.

    python3 tools/slice_blocks.py [--k 8,16,32,64]

Runs chip_smoke.py's phase 11 (``phase_loops``) at every k, without its
profile: the flagship slice (testdata/fit.cfg at full width, 544 repeats,
max_samples 1000) alone and as the fleet of seeds 43-46, in turns (the k in
order, the eager loop, the k in reverse), every turn's results bit for bit
the eager turn's.  For each k: wall seconds, slice iterations run and how
many of them ran beyond the eager loop's, ms per iteration, evals/s, graph
replays and flag reads per outer step.  Larger k means fewer host reads
and graph launches per outer step, and more iterations run after the last
chain's last pass (at most k - 1 per outer step).  Prints the card's name
and power limit, phase 11's lines and a JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", default="8,16,32,64")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = smoke.phase_device()
    smoke.phase_build()
    tmp = ROOT / "build" / "slice_blocks"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        rows = smoke.phase_loops(tmp, smi, None, None,
                                 ks=[int(x) for x in args.k.split(",")], profile=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": smi, "seeds": list(smoke.FLEET_SEEDS), "loops": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
