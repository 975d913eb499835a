"""The flagship fit's two-seed merged evidence on one CUDA card.

    python3 tools/flagship_merge.py [--seeds 43,44] [--num-repeats 544] [--bracket stepout]

Runs ``testdata/fit.cfg`` (ndim 34, nlive 200) through ``mcalf_torch.cli``
with ``[run] seeds`` at the bench's rung of 544 repeats, to convergence,
the seeds as one fleet (``--bracket``: the slice bracket, ``chord`` by
default or ``stepout``), and prints the wall time, the evaluations (the
sampler's device counters), the fused-kernel launches (counted per graph
replay), each seed's logZ and insertion-rank p, their mean and sd, the
merged logZ and the verdict of the flagship gate: every seed converged,
every rank p > 0.01, and the merged logZ within 2 sigma of the
repeats-ladder limit 4855.03, sigma the per-seed scatter 1.33 over
sqrt(seeds) combined with the limit's 0.44; the mean's distance from the
limit is printed against the same tolerance.  The chain
files go to ``build/flagship_merge/`` (git-ignored); the last line is one
JSON object, also written to ``chiprun_out/flagship_merge.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

LADDER_LIMIT, LADDER_LIMIT_SEM, SEED_SCATTER_SD = 4855.03, 0.44, 1.33


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="43,44")
    ap.add_argument("--num-repeats", type=int, default=544)
    ap.add_argument("--bracket", choices=("chord", "stepout"), default="chord")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flagship_merge: torch finds no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    seeds = [int(x) for x in args.seeds.split(",")]

    import numpy as np

    from mcalf_torch import cli, runner
    from mcalf_torch.io.chains import read_stats
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.sampler import graph

    out = ROOT / "build" / "flagship_merge"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    text = (ROOT / "testdata" / "fit.cfg").read_text()
    text = text.replace("datadir = testdata/", f"datadir = {ROOT / 'testdata'}/")
    text = text.replace("outdir = testdata/output/", f"outdir = {out}/")
    text = text.replace("doplot = True", f"doplot = False\nseeds = {args.seeds}")
    text += f"\n[ns_settings]\nnum_repeats = {args.num_repeats}\nbracket = {args.bracket}\n"
    cfg = out / "fit.cfg"
    cfg.write_text(text)

    fleets = []
    fit_stacked = runner.fit_stacked

    def recorded(*a, **k):
        fleets.append(fit_stacked(*a, **k))
        return fleets[-1]

    runner.fit_stacked = recorded
    log = io.StringIO()
    try:
        voigt_cuda.launches = 0
        graph.reset_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            rc = cli.main([str(cfg)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        runner.fit_stacked = fit_stacked
    evaluations = int(sum(int(np.sum(r.n_like)) for r in fleets))
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")

    base = str(out / "fits" / "pc_fits_0")
    merged_logz, merged_err = read_stats(base + ".stats")
    stats = Path(base + ".stats").read_text()
    per_seed = {
        int(m[1]): (float(m[2]), float(m[3]), float(m[4]))
        for m in re.finditer(
            r"# seed (\d+): logZ = ([-0-9.]+) \+/- ([0-9.]+); insertion-rank KS p = ([0-9.]+)",
            stats,
        )
    }
    if sorted(per_seed) != sorted(seeds):
        raise AssertionError(f"per-seed lines of {base}.stats: {sorted(per_seed)}")
    all_converged = "hit max_samples before" not in log.getvalue()
    tol = 2.0 * math.hypot(SEED_SCATTER_SD / math.sqrt(len(seeds)), LADDER_LIMIT_SEM)
    ok = (all_converged and all(p > 0.01 for _, _, p in per_seed.values())
          and abs(merged_logz - LADDER_LIMIT) < tol)
    for s in seeds:
        z, e, p = per_seed[s]
        print(f"[flagship merge] seed {s}: logZ {z:.3f} +/- {e:.3f}, rank p {p:.4f}")
    logz = np.array([per_seed[s][0] for s in seeds])
    mean, sd = float(logz.mean()), float(logz.std(ddof=1)) if len(seeds) > 1 else 0.0
    g = dict(graph.stats)
    print(f"[flagship merge] {len(seeds)} seeds at num_repeats={args.num_repeats}, bracket "
          f"{args.bracket}, as one fleet: "
          f"wall {wall:.1f} s, {evaluations} evaluations ({evaluations / wall:.4g} evals/s), "
          f"fused-kernel launches {voigt_cuda.launches} ({g['replays']} graph replays of "
          f"{g['captures']} graphs, {g['reads']} flag reads); per-seed logZ mean {mean:.3f}, sd "
          f"{sd:.3f}, |mean - {LADDER_LIMIT}| = {abs(mean - LADDER_LIMIT):.3f} against "
          f"{tol:.3f}; merged logZ {merged_logz:.3f} +/- {merged_err:.3f}, |d| = "
          f"{abs(merged_logz - LADDER_LIMIT):.3f} against {tol:.3f}; every seed converged: "
          f"{all_converged}; gate passed: {ok}  [{smi}]")
    record = {
        "card": smi, "seeds": seeds, "num_repeats": args.num_repeats, "bracket": args.bracket,
        "wall_s": wall,
        "evaluations": evaluations, "launches": voigt_cuda.launches, "graph": g,
        "per_seed": {str(s): per_seed[s] for s in seeds},
        "mean_logz": mean, "sd_logz": sd, "mean_within_tolerance": abs(mean - LADDER_LIMIT) < tol,
        "merged_logz": merged_logz, "merged_logzerr": merged_err,
        "gate_tolerance": tol, "all_converged": all_converged, "gate_passed": ok,
    }
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flagship_merge.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
