#!/usr/bin/env python3
"""Flagship evidence-convergence study with the PyTorch/CUDA port: the twin
of tools/flagship_study.py, with the same jobs.

    python3 tools/torch_flagship_study.py [out.jsonl] [mode] [--device cuda|cpu]

``mode`` picks the jobs (:func:`build_jobs`, the JAX script's list for
every mode: ``full``, ``anchor544``, ``recal``, ``fixedk544``).  Each job is
the 10-component CIV flagship fit (testdata/civ_mock_spec_multicomp.txt,
nlive 200, canon_layout gauge fixing) at a number of repeats, deletions and
component range, with one seed.  Jobs that share (ncomp, repeats,
deletions) run together as one :func:`mcalf_torch.parallel.fit_many` fleet
on the card, each seed on its own generator (``torch.Generator``
``manual_seed(seed)``, so a job is its solo fit bit for bit).  Each job
appends one JSON line, the JAX record's keys plus ``fleet`` (the fleet's
size; ``wall_s`` is the fleet's wall), as its fleet finishes.

``fixedk544`` fits ncomp fixed at 8, 9 and 10 on seeds 63 and 64: with a
uniform ncomp prior on [8, 11] (floor, so mass 1/3 each; 11 has measure
zero) the flagship evidence is Z = logsumexp(Z8, Z9, Z10) - ln 3, a check
that does not lean on the repeats ladder.  After those jobs the script
prints that decomposition for each seed and for the seeds' mean logZ_k,
with its distance from the ladder limit 4855.03 (against 2 hypot(1.33 /
sqrt(seeds), 0.44)) and from the port's own 8-seed merged 4855.983 +-
0.371 (seeds 101-108 as one fleet), as one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

#: the repeats ladder's limit and its standard error, and the per-seed sd of
#: the flagship logZ (bench.py)
LADDER_LIMIT, LADDER_LIMIT_SEM, SEED_SCATTER_SD = 4855.03, 0.44, 1.33
#: the port's merged logZ of seeds 101-108 at 544 repeats (tools/flagship_merge.py)
PORT_MERGED, PORT_MERGED_ERR = 4855.983, 0.371


def make_model(ncomp):
    from mcalf_torch.models import AbsorptionModel

    return AbsorptionModel.from_file(
        os.path.join(os.path.dirname(HERE), "testdata", "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=ncomp,
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )


def build_jobs(mode="full"):
    """(tag, ncomp, num_repeats, num_delete, seed) of every fit of
    ``mode``: the JAX script's lists."""
    jobs = []
    if mode == "anchor544":
        for seed in (51, 52, 53, 54):
            jobs.append(("anchor544", (8, 11), 544, 100, seed))
        return jobs
    if mode == "recal":
        for seed in range(55, 63):
            jobs.append(("recal272", (8, 11), 272, 100, seed))
        for seed in range(55, 59):
            jobs.append(("recal544", (8, 11), 544, 100, seed))
        for seed in (55, 56):
            jobs.append(("recal1088", (8, 11), 1088, 100, seed))
        return jobs
    if mode == "fixedk544":
        for k in (8, 9, 10):
            for seed in (63, 64):
                jobs.append((f"fixedk544_{k}", (k, k), 544, 100, seed))
        return jobs
    for nr in (68, 136, 272, 544):
        for seed in (43, 44):
            jobs.append(("ladder", (8, 11), nr, 100, seed))
    for seed in (43, 44):
        jobs.append(("b50", (8, 11), 272, 50, seed))
    for k in (8, 9, 10):
        for seed in (43, 44):
            jobs.append((f"fixed{k}", (k, k), 272, 100, seed))
    for seed in (43, 44):
        jobs.append(("ladder1088", (8, 11), 1088, 100, seed))
    for nr in (544, 272):
        for seed in (43, 44):
            jobs.append(("async_sched", (8, 11), nr, 100, seed))
    return jobs


def fleets(jobs):
    """The jobs grouped by (ncomp, num_repeats, num_delete), in order of
    first appearance: each group is one fleet."""
    groups = collections.OrderedDict()
    for job in jobs:
        groups.setdefault((job[1], job[2], job[3]), []).append(job)
    return list(groups.values())


def config(model, num_repeats, num_delete):
    """The JAX script's sampler settings for ``model``."""
    from mcalf_torch.sampler import NSConfig

    return NSConfig(ndim=model.ndim, nlive=200, num_repeats=num_repeats, num_delete=num_delete,
                    max_samples=60000, precision_criterion=1e-3,
                    canon_layout=model.canon_layout())


def run_fleet(group, device):
    """Fit one group of jobs as one fleet; returns its JSON records."""
    import torch

    from mcalf_torch.parallel import fit_many
    from mcalf_torch.sampler import insertion_rank_test
    from mcalf_torch.sampler.nested import unstack_results

    _, ncomp, nr, nd, _ = group[0]
    model = make_model(ncomp)
    cfg = config(model, nr, nd)
    gens = [torch.Generator(device=device).manual_seed(job[4]) for job in group]
    t0 = time.perf_counter()
    res = fit_many([model] * len(group), cfg, mesh=[device], generators=gens)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    recs = []
    for (tag, _, _, _, seed), r in zip(group, unstack_results(res)):
        r = r.numpy()
        d = insertion_rank_test(r, cfg)
        recs.append({
            "tag": tag, "ncomp": list(ncomp), "ndim": model.ndim,
            "num_repeats": cfg.num_repeats, "num_delete": cfg.num_delete, "seed": seed,
            "logz": round(float(r.logz), 3), "logzerr": round(float(r.logzerr), 3),
            "h": round(float(r.h), 2), "n_like": int(r.n_like), "n_dead": int(r.n_dead),
            "rank_p": round(d.p_value, 5), "rank_p_blocks": round(d.p_value_blocks, 5),
            "converged": int(r.termination_reason) == 0, "wall_s": round(dt, 1),
            "fleet": len(group),
        })
    return recs


def decompose(records) -> dict:
    """The fixed-k decomposition Z = logsumexp(Z8, Z9, Z10) - ln 3 for each
    seed and for the seeds' mean logZ_k, with its distances from the ladder
    limit and the port's merged evidence."""
    by = collections.defaultdict(dict)
    for r in records:
        by[r["seed"]][r["ncomp"][0]] = r["logz"]
    ks = sorted({k for z in by.values() for k in z})
    seeds = sorted(s for s in by if sorted(by[s]) == ks)

    def z_of(logz_k):
        a = np.asarray(logz_k, np.float64)
        return float(a.max() + np.log(np.exp(a - a.max()).sum()) - math.log(len(a)))

    out = {"ks": ks, "seeds": seeds, "per_seed": {}}
    for s in seeds:
        out["per_seed"][str(s)] = {"logz_k": [by[s][k] for k in ks], "logz": z_of([by[s][k] for k in ks])}
    if seeds:
        mean_k = [float(np.mean([by[s][k] for s in seeds])) for k in ks]
        z = z_of(mean_k)
        tol = 2.0 * math.hypot(SEED_SCATTER_SD / math.sqrt(len(seeds)), LADDER_LIMIT_SEM)
        tol_port = 2.0 * math.hypot(SEED_SCATTER_SD / math.sqrt(len(seeds)), PORT_MERGED_ERR)
        out["together"] = {
            "logz_k": mean_k, "logz": z,
            "d_ladder": z - LADDER_LIMIT, "tol_ladder": tol, "ok_ladder": abs(z - LADDER_LIMIT) < tol,
            "d_port_merged": z - PORT_MERGED, "tol_port_merged": tol_port,
            "ok_port_merged": abs(z - PORT_MERGED) < tol_port,
        }
        for s in seeds:
            zs = out["per_seed"][str(s)]["logz"]
            tol1 = 2.0 * math.hypot(SEED_SCATTER_SD, LADDER_LIMIT_SEM)
            out["per_seed"][str(s)].update(d_ladder=zs - LADDER_LIMIT, tol_ladder=tol1,
                                           d_port_merged=zs - PORT_MERGED)
    return out


def main(out_path, mode="full", device="cuda", log=print) -> dict:
    """Run every fleet of ``mode``, appending each job's record to
    ``out_path``; returns the fixed-k decomposition of the fixed-ncomp jobs
    (empty without them)."""
    records = []
    for group in fleets(build_jobs(mode)):
        recs = run_fleet(group, device)
        with open(out_path, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
                log(json.dumps(rec))
        records += recs
    fixed = [r for r in records if r["ncomp"][0] == r["ncomp"][1]]
    summary = decompose(fixed) if fixed else {}
    if summary:
        log(json.dumps({"decomposition": summary}))
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="flagship_study.jsonl")
    ap.add_argument("mode", nargs="?", default="full",
                    choices=("full", "anchor544", "recal", "fixedk544"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_flagship_study: torch finds no CUDA device", file=sys.stderr)
        sys.exit(2)
    main(args.out, args.mode, args.device)
