"""The comparison that decides ``correct``: what the timed fits produced,
against the plain float64 reference.

For every fit of the window and every seed of its fleet (the runs the
runner merged, and the chain files it wrote), on rows drawn from the run's
seed:

* ``logl_rel``: the widest gap between a dead point's log L as the fit
  recorded it and the reference's log L of the same unit-cube row, in units
  of the port's bar (0.05 + 1e-5 |log L|); the rows are the two best of each
  seed's dead points and six drawn at random (in a resumed fit, from the
  dead points past its checkpoint);
* ``logz_rel``: the widest gap between a log Z the fit wrote (each seed's
  ``.stats`` and the merged ``.stats``) and the reference's log Z of the
  same run's log L sequence (each seed: its deletions and final live set;
  the merge: every seed's points by birth contours), in the same units as
  ``logl_rel`` (a capped fit's |log Z| is 1e4 to 1e5, where a float32 log Z
  is rounded to 2e-3 to 8e-3 nats);
* ``logw_gap``: the widest gap between a prior-mass weight the fit reported
  and the reference's, in nats;
* ``param_gap``: the widest gap, as a share of the prior width, between a
  parameter row written to an ``_equal_weights.txt`` file and the
  reference's prior transform of the unit-cube point that row came from
  (found by its log L);
* ``order_breaks``: deaths out of order (a dead point below the one before
  it) and births at or above the point's own log L, counted;
* ``dup_rows``: dead points that repeat an earlier dead point exactly;
* ``resume_breaks``: in a fit resumed from a checkpoint, dead points before
  the checkpoint's count whose unit-cube row or log L is not bit for bit
  the checkpoint's (0 where a fit starts afresh);
* ``failed_fits``: fits that raised or wrote no files.

Every number covers the whole run, the part before a checkpoint too.  The
last four are exact (limit 0).  :func:`control_numbers` gives the
same numbers for the reference put in the program's place at the next
precision below float32 (TF32 in the line-spread convolution, bfloat16 in
the weights, the evidence and the prior transform).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from benchmark.reference import evidence
from benchmark.reference.physics import Problem, to_bf16

#: the rows of each seed's dead points compared: the best, and drawn ones
TOP_ROWS, DRAWN_ROWS, FILE_ROWS = 2, 6, 8
EXACT = ("order_breaks", "dup_rows", "resume_breaks", "failed_fits")


def _stats_logz(path: str) -> float:
    with open(path) as fh:
        for line in fh:
            if line.startswith("log(Z)"):
                return float(line.split()[2])
    raise ValueError(f"{path}: no log(Z) line")


def _rel(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    both = np.isfinite(a) & np.isfinite(ref)
    gap = np.where(both, np.abs(a - ref) / (0.05 + 1e-5 * np.abs(np.where(both, ref, 0.0))), np.inf)
    return np.where(np.isneginf(a) & np.isneginf(ref), 0.0, gap)


class Fit:
    """One fit of the window as the check reads it: its seeds, the runs
    (per seed, host numpy ``NSResults``-like objects with ``samples_u``,
    ``logl``, ``logw``, ``birth_logl``, ``logz``, ``n_dead``), the chain
    basename its files were written under (None if it failed), and the
    checkpoint it resumed from (a ``harness.Resume``: ``n_dead``,
    ``dead_u``, ``dead_logl``), or None."""

    def __init__(self, seeds: List[int], runs: list, base, max_samples: int, num_delete: int,
                 resume=None):
        self.seeds, self.runs, self.base = list(seeds), list(runs), base
        self.max_samples, self.num_delete = int(max_samples), int(num_delete)
        self.resume = resume


def _split(run, cap):
    logl = np.asarray(run.logl, np.float64)
    nlive = logl.size - cap
    n_del = int(run.n_dead) - nlive
    return nlive, n_del, logl


def _rows(run, cap, rng, start=0):
    nlive, n_del, logl = _split(run, cap)
    dead = logl[:n_del]
    top = np.argsort(dead, kind="stable")[-TOP_ROWS:]
    late = max(n_del - start, 0)
    drawn = start + rng.choice(late, size=min(DRAWN_ROWS, late), replace=False)
    idx = np.unique(np.concatenate([top, drawn]))
    return np.asarray(run.samples_u, np.float32)[idx], dead[idx]


def _resume_breaks(run, cap, resume) -> int:
    """Dead points before the checkpoint's count that are missing from the
    run or differ, in any bit of their unit-cube row or log L, from the
    checkpoint's."""
    if resume is None:
        return 0
    _, n_del, _ = _split(run, cap)
    n = min(resume.n_dead, n_del)
    u = np.asarray(run.samples_u, np.float32)[:n].view(np.uint32)
    logl = np.asarray(run.logl, np.float32)[:n].view(np.uint32)
    differ = np.any(u != resume.dead_u[:n].view(np.uint32), axis=1)
    differ |= logl != resume.dead_logl[:n].view(np.uint32)
    return resume.n_dead - n + int(differ.sum())


def _valid_points(run):
    ok = np.isfinite(np.asarray(run.logw, np.float64))
    return np.asarray(run.samples_u, np.float32)[ok], np.asarray(run.logl, np.float32)[ok]


def _param_gap(problem: Problem, path: str, points, rng, rounding=None) -> float:
    """Widest gap of sampled rows of an ``_equal_weights.txt`` file against
    the reference transform of the point each row came from."""
    rows = np.loadtxt(path, ndmin=2)
    pick = rng.choice(len(rows), size=min(FILE_ROWS, len(rows)), replace=False)
    u_all, logl_all = points
    key = -2.0 * logl_all.astype(np.float64)
    width = problem.hi - problem.lo
    worst = 0.0
    for r in rows[pick]:
        match = np.flatnonzero(key == r[1])
        if match.size == 0:
            return np.inf
        ref = problem.params(u_all[match])
        # the control writes the reference's transform at its own precision
        got = r[2:] if rounding is None else np.asarray(rounding(ref), np.float64)
        worst = max(worst, float(np.min(np.max(np.abs(got - ref) / width, axis=1))))
    return worst


def compare(problem: Problem, fits: List[Fit], seed: int, control: bool = False) -> Dict[str, float]:
    """The numbers compared, for the program's outputs (or, with
    ``control``, for the reference at lower precision in its place)."""
    out = dict(logl_rel=0.0, logz_rel=0.0, logw_gap=0.0, param_gap=0.0,
               order_breaks=0, dup_rows=0, resume_breaks=0, failed_fits=0)
    U, L = [], []
    bf = to_bf16 if control else None
    for f, fit in enumerate(fits):
        if fit.base is None or not fit.runs or not os.path.exists(fit.base + ".stats"):
            out["failed_fits"] += 1
            continue
        cap, nd = fit.max_samples, fit.num_delete
        for q, (s, run) in enumerate(zip(fit.seeds, fit.runs)):
            rng = np.random.default_rng([seed & (2**63 - 1), f, q])
            u, logl = _rows(run, cap, rng, 0 if fit.resume is None else fit.resume.n_dead)
            U.append(u)
            L.append(logl)
            nlive, n_del, all_logl = _split(run, cap)
            dead, live = all_logl[:n_del], all_logl[cap:cap + nlive]
            ref_z = evidence.run_logz(dead, live, nlive, nd)
            if control:
                got_z = evidence.run_logz(dead, live, nlive, nd, rounding=bf)
                w, lw = evidence.run_weights(n_del, nlive, nd, rounding=bf)
            else:
                got_z = _stats_logz(f"{fit.base}_s{s}.stats" if len(fit.runs) > 1
                                    else fit.base + ".stats")
                lw_all = np.asarray(run.logw, np.float64)
                w, lw = lw_all[:n_del], lw_all[cap:cap + nlive]
            ref_w, ref_lw = evidence.run_weights(n_del, nlive, nd)
            out["logz_rel"] = max(out["logz_rel"], float(_rel(got_z, ref_z)))
            gap_w = max(float(np.max(np.abs(w - ref_w), initial=0.0)),
                        float(np.max(np.abs(np.asarray(lw) - ref_lw), initial=0.0)))
            out["logw_gap"] = max(out["logw_gap"], gap_w)
            birth = np.asarray(run.birth_logl, np.float64)[:n_del]
            out["order_breaks"] += int(np.sum(np.diff(dead) < 0))
            out["order_breaks"] += int(np.sum(np.isfinite(birth) & (birth >= dead)))
            du = np.asarray(run.samples_u, np.float32)[:n_del]
            out["dup_rows"] += n_del - int(np.unique(du, axis=0).shape[0])
            out["resume_breaks"] += _resume_breaks(run, cap, fit.resume)
        pts = [_valid_points(r) for r in fit.runs]
        pooled = (np.concatenate([p[0] for p in pts]), np.concatenate([p[1] for p in pts]))
        rng = np.random.default_rng([seed & (2**63 - 1), f, 10**6])
        files = [(fit.base + "_equal_weights.txt", pooled)]
        if len(fit.runs) > 1:
            q = int(rng.integers(len(fit.runs)))
            files.append((f"{fit.base}_s{fit.seeds[q]}_equal_weights.txt", pts[q]))
            runs = []
            for r in fit.runs:
                ok = np.isfinite(np.asarray(r.logw, np.float64))
                runs.append((np.asarray(r.logl, np.float64)[ok], np.asarray(r.birth_logl, np.float64)[ok]))
            ref_m = evidence.merged_logz(runs)
            got_m = (float(to_bf16(ref_m)) if control else _stats_logz(fit.base + ".stats"))
            out["logz_rel"] = max(out["logz_rel"], float(_rel(got_m, ref_m)))
        for path, points in files:
            out["param_gap"] = max(out["param_gap"], _param_gap(problem, path, points, rng, bf))
    if U:
        U, L = np.concatenate(U), np.concatenate(L)
        ref = problem.loglike(U)
        got = problem.loglike(U, tf32=True) if control else L
        out["logl_rel"] = float(np.max(_rel(got, ref)))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits) and all(numbers[k] == 0 for k in EXACT)


def control_numbers(problem: Problem, fits: List[Fit], seed: int) -> Dict[str, float]:
    return compare(problem, fits, seed, control=True)
