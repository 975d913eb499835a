#!/usr/bin/env python3
"""Simulation-based posterior-coverage calibration (SBC) of the port's
sampler: the twin of tools/coverage_study.py.

Draw truths from the prior, make noisy 1-component CIV mock spectra of
them, fit every realization with the port's production path -- all of them
as one stacked fleet on the card (:func:`mcalf_torch.parallel.fit_many`:
one fused-kernel launch per slice iteration for every problem) -- and test

* SBC rank uniformity -- for each parameter, the weighted posterior rank
  of the truth, ``r = sum_i w_i 1[u_i < u*]``, must be U(0,1) across
  realizations (in unit-cube coordinates: the prior transform is monotone
  per dimension, so cube ranks are physical ranks);
* central credible-interval coverage -- the truth must fall inside the
  central 68%/95% (weighted-quantile) intervals for the binomially expected
  fraction of realizations.

The truths and the mocks come from ``np.random.default_rng(seed)`` in the
JAX study's order, through this package's numpy ``scale_cube`` and
``reconstruct_spec``, so they are the JAX study's spectra byte for byte.
Usage:

    python3 tools/torch_coverage_study.py [out.json] [n_realizations] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

#: pixels of each mock spectrum
NPIX = 300


def _weighted_quantile(x, w, q):
    """Quantiles of samples ``x`` with normalized weights ``w``."""
    order = np.argsort(x)
    cw = np.cumsum(w[order])
    return np.interp(q, cw, x[order])


def make_problems(n_real, seed, noise_sigma):
    """(truths in the unit cube (n_real, ndim) float32, the mock problems):
    the JAX study's draws, in its order."""
    from mcalf_torch.atomic import get_lines
    from mcalf_torch.models import AbsorptionModel

    wave = np.linspace(6180.0, 6220.0, NPIX)
    kw = dict(
        lines=get_lines(["CIV 1548", "CIV 1550"]), ncomp=(1, 1), specres=[8.0],
        Nrange=[12.8, 14.0], brange=[10.0, 40.0], zrange=[2.997, 3.003],
    )
    base = AbsorptionModel(wave=wave, flux=np.ones(NPIX), noise=np.full(NPIX, noise_sigma), **kw)
    rng = np.random.default_rng(seed)
    truths_u = rng.uniform(size=(n_real, base.ndim)).astype(np.float32)
    problems = []
    for i in range(n_real):
        clean = base.reconstruct_spec(base.scale_cube(truths_u[i]))
        noisy = clean + rng.normal(0.0, noise_sigma, NPIX)
        problems.append(AbsorptionModel(wave=wave, flux=noisy, noise=np.full(NPIX, noise_sigma), **kw))
    return truths_u, problems


def summarize(samples, logpw, truths_u, termination, nlive) -> dict:
    """The JAX study's summary of fitted realizations: weighted ranks of
    the truths, their KS p-values, and 68%/95% interval coverage."""
    from scipy import stats

    n_real, _, ndim = samples.shape
    ranks = np.empty((n_real, ndim))
    cover = {0.68: np.zeros((n_real, ndim), bool), 0.95: np.zeros((n_real, ndim), bool)}
    for i in range(n_real):
        w = np.exp(logpw[i] - logpw[i].max())
        w /= w.sum()
        for d in range(ndim):
            x = samples[i, :, d]
            ranks[i, d] = float(w[x < truths_u[i, d]].sum())
            for lvl in (0.68, 0.95):
                lo, hi = _weighted_quantile(x, w, [(1 - lvl) / 2, 1 - (1 - lvl) / 2])
                cover[lvl][i, d] = lo <= truths_u[i, d] <= hi
    ks_p = [float(stats.kstest(ranks[:, d], "uniform").pvalue) for d in range(ndim)]
    out = {
        "n_realizations": n_real,
        "ndim": ndim,
        "nlive": nlive,
        "converged_all": bool(np.all(np.asarray(termination) == 0)),
        "rank_ks_p": [round(p, 4) for p in ks_p],
        "coverage": {},
    }
    for lvl in (0.68, 0.95):
        frac = cover[lvl].mean(axis=0)
        tol = 3.0 * np.sqrt(lvl * (1 - lvl) / n_real)
        out["coverage"][str(lvl)] = {
            "fraction_per_dim": [round(float(f), 3) for f in frac],
            "binomial_3sigma_tol": round(float(tol), 3),
            "ok": bool(np.all(np.abs(frac - lvl) <= tol)),
        }
    out["ranks_ok"] = bool(min(ks_p) > 0.01 / ndim)  # Bonferroni at 1%
    return out


def run_coverage(n_real=64, nlive=100, max_samples=6000, seed=20260819, mesh=None,
                 noise_sigma=0.02, fit_stats=None):
    """Run the SBC battery; returns the JAX study's summary dict.

    The problems are fitted as one stacked fleet with :func:`fit_many` on
    ``mesh`` (the current card by default; ``["cpu"]`` for the CPU), so this
    also drives the fleet path end to end with structurally identical but
    data-distinct problems.  ``fit_stats``: a dict that receives the fit's
    wall seconds, evaluations and most outer steps."""
    from mcalf_torch.parallel import fit_many
    from mcalf_torch.sampler import NSConfig

    truths_u, problems = make_problems(n_real, seed, noise_sigma)
    cfg = NSConfig(ndim=problems[0].ndim, nlive=nlive, max_samples=max_samples)
    t0 = time.perf_counter()
    res = fit_many(problems, cfg, seed=seed % 100000, mesh=mesh).numpy()
    wall = time.perf_counter() - t0
    if fit_stats is not None:
        fit_stats.update(wall_s=wall, n_like=int(np.sum(res.n_like)),
                         n_iter_max=int(np.max(res.n_iter)))
    return summarize(np.asarray(res.samples_u), np.asarray(res.log_posterior_weights, np.float64),
                     truths_u, res.termination_reason, nlive)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=None, help="write the summary JSON here")
    ap.add_argument("n_real", nargs="?", type=int, default=64)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the current card)")
    args = ap.parse_args()
    fit = {}
    summary = run_coverage(n_real=args.n_real, mesh=None if args.device is None else [args.device],
                           fit_stats=fit)
    summary["fit"] = fit
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
