#!/usr/bin/env python3
"""Model-grid fitting with the PyTorch/CUDA port: one fleet per fixed
component count, and the evidence table (the twin of examples/model_grid.py).

The reference explores the component count inside one run (the sampled
ncomp dimension).  The classical alternative -- one fit per fixed component
count, compared by evidence -- is embarrassingly parallel: here the seeds of
each candidate model run as one stacked fleet on the card
(:func:`mcalf_torch.parallel.fit_stacked`, one kernel launch per slice
iteration for all of them).

This example fits the bundled single-component CIV mock at fixed ncomp = 1
and 2, four seeds each, prints the evidence table with Bayes factors, and
merges each model's seeds for a tighter logZ.  Run on the card:

    python3 examples/model_grid_torch.py [--device cuda|cpu] [--nlive 60]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

NCOMP_GRID = (1, 2)
SEEDS_PER_MODEL = 4


def fixed_model(spec, k, kmax):
    """The CIV model at ncompmax = ``kmax`` (one parameter layout for the
    whole grid) with its ncomp prior pinned to the single value ``k``."""
    from mcalf_torch.models import AbsorptionModel

    m = AbsorptionModel.from_file(
        spec,
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(k, kmax),
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )
    m.bounds[m.startind] = (float(k), float(k) + 1e-3)
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--nlive", type=int, default=60)
    ap.add_argument("--max-samples", type=int, default=4000)
    ap.add_argument("--num-repeats", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.parallel import fit_stacked
    from mcalf_torch.sampler import NSConfig
    from mcalf_torch.sampler.merge import merge_results
    from mcalf_torch.sampler.nested import unstack_results

    if args.device != "cpu" and not torch.cuda.is_available():
        print("model_grid_torch: torch finds no CUDA device (--device cpu for the CPU)",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    spec = os.path.join(here, "..", "testdata", "civ_mock_spec.txt")
    kmax = max(NCOMP_GRID)
    # Demo budgets; production evidences want nlive >= 200 and
    # num_repeats >= 8*ndim.
    merged, table = {}, []
    for k in NCOMP_GRID:
        m = fixed_model(spec, k, kmax)
        problems = [m] * SEEDS_PER_MODEL
        stat, stacked = stack_problems(problems)
        # the edited ncomp bounds into the stacked constants
        stacked["lo"] = np.stack([p.bounds_lo for p in problems]).astype(np.float32)
        stacked["hi"] = np.stack([p.bounds_hi for p in problems]).astype(np.float32)
        cfg = NSConfig(ndim=m.ndim, nlive=args.nlive, max_samples=args.max_samples,
                       precision_criterion=0.05, num_repeats=args.num_repeats)
        gens = [torch.Generator(device=args.device).manual_seed(17 + 100 * k + j)
                for j in range(SEEDS_PER_MODEL)]
        print(f"Fitting ncomp = {k}: {SEEDS_PER_MODEL} seeds as one fleet on {args.device}...")
        res = fit_stacked(stat, stacked, cfg, mesh=[args.device], generators=gens)
        runs = unstack_results(res)
        merged[k] = merge_results(runs)
        table.append((k, [float(r.logz) for r in runs]))

    print("\n  ncomp |    logZ (merged over seeds)   | dlogZ vs best")
    best = max(m.logz for m in merged.values())
    for k in NCOMP_GRID:
        m = merged[k]
        print(f"    {k:3d} | {m.logz:10.2f} +/- {m.logzerr:5.2f}       | {m.logz - best:8.2f}")
    for k, logzs in table:
        print(f"  ncomp = {k} seeds: " + ", ".join(f"{z:.2f}" for z in logzs))
    kbest = max(merged, key=lambda k: merged[k].logz)
    print(
        f"\nPreferred model: ncomp = {kbest} (truth: 1; demo budgets are "
        "small -- production evidences want nlive>=200, num_repeats>=8*ndim)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
