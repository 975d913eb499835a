"""Per-seed evidence and posterior modes of the HI-forest fit
(testdata/hi_forest.cfg at its shipped settings), for either package.

    python3 tools/hi_forest_seeds.py --seeds 1,2,...,16                # the port, on the card
    python3 tools/hi_forest_seeds.py --device cpu --seeds 1,2          # the port, on the CPU
    JAX_PLATFORMS=cpu python3 tools/hi_forest_seeds.py --package mcalf_tpu --seeds 1,...,8 --jobs 2

The port fits every seed as one fleet (``[run] seeds``, one process); the
JAX package fits one seed per process (``[run] seed = s``), ``--jobs`` at a
time.  Both through the package's own CLI (``python -m <package>``, no
plot).  For each seed it reads the chain files and prints logZ, its error,
the insertion-rank p-value, the ncomp fractions, among the ncomp = 2 rows
the share with the filler on each of the three absorbers (the two HI Lya
components and the CIV contaminant: which absorber the filler models is
not identified by the data), the posterior's largest and mean log L, and
a witness of the likelihood: the ``--check`` highest-likelihood rows of
the posterior re-evaluated by the port's plain PyTorch likelihood on the
CPU (the fit's own convention: float32, the LSF convolution reset at the
spectrum's edges) against the log L the fit recorded, and by the float64
numpy model (``AbsorptionModel.lnlhood``, whose convolution wraps at the
edges, as the plot and the mocks do).  Then
the seeds' mean and sd; the whole is written to
``<out>/hi_forest_seeds_<package>.json``.  The analysis is host numpy
(``mcalf_torch.analysis``) for either package's files.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _config(out: Path, run_lines: str) -> Path:
    from mcalf_torch.mocks import hi_forest_config

    cfg = Path(hi_forest_config(str(out), str(ROOT / "testdata"), run_lines))
    cfg.write_text(cfg.read_text().replace("doplot = True", "doplot = False"))
    return cfg


def _cli(package: str, cfg: Path) -> str:
    proc = subprocess.run([sys.executable, "-m", package, str(cfg)], cwd=str(ROOT),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{package} {cfg}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return proc.stdout


def _read(base: str, model, stats: str, check: int) -> dict:
    """One seed's chain files; its rank p-value from ``stats`` (its own
    .stats, or a seed ensemble's merged one, which holds every seed's)."""
    from mcalf_torch.analysis import analyze_chains, ncomp_occurrence
    from mcalf_torch.io.chains import read_equal_weights
    from mcalf_torch.mocks import hi_absorbers
    from mcalf_torch.models import make_torch_forward

    logz, err, lnl, post = analyze_chains(base, nfill=model.nfill)
    m = re.search(r"insertion-rank KS p = ([0-9.]+)", stats)
    vals, frac, mapn = ncomp_occurrence(post, model.startind)
    _, wobs, share = hi_absorbers(post, model)
    raw = read_equal_weights(base + "_equal_weights.txt")[:, 2:]
    top = np.argsort(-lnl, kind="stable")[:check]
    plain = make_torch_forward(model, "cpu").loglike(torch.from_numpy(raw[top]).float())
    plain = plain.double().numpy()
    ref = np.array([model.lnlhood(raw[i]) for i in top])
    return {
        "logz": float(logz), "logzerr": float(err),
        "rank_p": float(m[1]) if m else None,
        "ncomp": {int(v): round(float(f), 4) for v, f in zip(vals, frac)},
        "map_ncomp": int(mapn),
        "absorbers": [round(w, 4) for w in wobs],
        "filler_on": [round(f, 4) for f in share],
        "max_lnl": float(lnl.max()), "mean_lnl": float(lnl.mean()),
        "lnl_check_rows": int(len(top)),
        "lnl_check_plain": float(np.max(np.abs(plain - lnl[top]))),
        "lnl_check_numpy_wrap": float(np.max(np.abs(ref - lnl[top]))),
        "rows": int(len(post)),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default="mcalf_torch", choices=("mcalf_torch", "mcalf_tpu"))
    ap.add_argument("--seeds", default="1,2,3,4")
    ap.add_argument("--device", default="default", help="mcalf_torch's [run] device")
    ap.add_argument("--jobs", type=int, default=1, help="mcalf_tpu: processes at a time")
    ap.add_argument("--check", type=int, default=50,
                    help="highest-likelihood rows per seed re-evaluated in float64 numpy")
    ap.add_argument("--out", default=str(ROOT / "build" / "hi_forest_seeds"))
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out) / args.package

    from mcalf_torch.config import readconfig
    from mcalf_torch.runner import build_model, chain_basename

    t0 = time.perf_counter()
    if args.package == "mcalf_torch":
        cfg = _config(out, f"device = {args.device}\nseeds = {args.seeds}")
        _cli(args.package, cfg)
        base = chain_basename(readconfig(str(cfg)))
        bases = {s: f"{base}_s{s}" for s in seeds}
        merged = Path(base + ".stats").read_text().splitlines()
        stats = {s: next((ln for ln in merged if f"seed {s}: logZ" in ln), "")
                 for s in seeds}
    else:
        cfgs = {s: _config(out / f"seed{s}", f"seed = {s}") for s in seeds}
        with ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(lambda c: _cli(args.package, c), cfgs.values()))
        bases = {s: chain_basename(readconfig(str(c))) for s, c in cfgs.items()}
        cfg = cfgs[seeds[0]]
        stats = {s: Path(b + ".stats").read_text() for s, b in bases.items()}
    wall = time.perf_counter() - t0
    model = build_model(readconfig(str(cfg)))
    rows = {s: _read(b, model, stats[s], args.check) for s, b in bases.items()}
    logz = np.array([r["logz"] for r in rows.values()])
    summary = {"package": args.package, "device": args.device if args.package == "mcalf_torch" else "cpu",
               "seeds": seeds, "wall_s": wall, "mean": float(logz.mean()),
               "sd": float(logz.std(ddof=1)) if len(logz) > 1 else None, "per_seed": rows}
    for s, r in rows.items():
        print(f"seed {s}: logZ {r['logz']:.3f} +/- {r['logzerr']:.3f}, rank p {r['rank_p']}, "
              f"ncomp {r['ncomp']}, absorbers {r['absorbers']}, filler on (HI a, HI b, CIV) "
              f"{r['filler_on']}, max / mean log L {r['max_lnl']:.3f} / {r['mean_lnl']:.3f}, "
              f"the {r['lnl_check_rows']} best rows' log L within {r['lnl_check_plain']:.3g} of "
              f"the plain version on the CPU, {r['lnl_check_numpy_wrap']:.3g} of numpy's "
              f"(float64, wrapped edges)")
    print(f"{args.package}: {len(seeds)} seeds in {wall:.1f} s, mean logZ {summary['mean']:.4f}, "
          f"sd {summary['sd']}")
    (Path(args.out) / f"hi_forest_seeds_{args.package}.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
