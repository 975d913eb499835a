"""Fit orchestration: config dict -> model -> sampler -> chain files.

Port of :mod:`mcalf_tpu.runner` on its single-spectrum branch: every solver
name the reference accepts runs the same native nested sampler, its
settings section tuning it, and the fit writes ``.stats`` and
``_equal_weights.txt`` in the reference formats (through the port's copy,
:mod:`mcalf_torch.io.chains`).  The other branches of the JAX runner --
seed ensembles, ``ncomp_grid``, multi-spectrum fleets, dynamic sampling,
``auto_repeats``, checkpoint/resume and ``write_dead`` -- are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.

``[run] device``: ``default`` (or ``cuda``/``cuda:N``) fits on the GPU and
raises when there is none; ``cpu`` is the explicit CPU choice.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mcalf_torch.atomic import load_atomfile
from mcalf_torch.io.chains import write_equal_weights, write_stats
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.sampler import (
    NSConfig,
    NSResults,
    equal_weights_matrix,
    insertion_rank_test,
    nested_sample,
    resample_equal,
)

KNOWN_SOLVERS = (
    "polychord",
    "dypolychord",
    "multinest",
    "dynesty",
    "jaxns",
    "ns",
    "native",
    "tpu-ns",
)


def _as_bool(v, default=False):
    """Settings boolean: config values arrive as strings, and
    ``bool("false")`` is True."""
    if isinstance(v, bool):
        return v
    if v is None:
        return default
    return str(v).strip().lower() in ("true", "1", "yes")


#: Recognized keys per settings section (as in the JAX runner); any other
#: key draws a warning.
_KNOWN_SETTINGS = {
    "pc_settings": {
        "nlive", "num_repeats", "precision_criterion", "do_clustering",
        "feedback", "equals", "read_resume", "write_resume", "write_live",
        "write_dead", "write_prior", "posteriors", "cluster_posteriors",
        "dynamic_goal",
    },
    "mn_settings": {"nlive", "samplingeff", "evidence_tolerance"},
    "jaxns_settings": {"max_samples", "num_live_points", "difficult_model"},
    "ns_settings": {
        "nlive", "num_repeats", "num_delete", "precision_criterion",
        "max_samples", "difficult_model", "max_clusters", "dynamic",
        "auto_repeats", "bracket", "stepout_w", "stepout_budget",
        "boost_start_mass", "boost_nlive", "boost_num_repeats",
        "boost_max_samples",
    },
}


def _warn_unknown_settings(configpars) -> None:
    for section, known in _KNOWN_SETTINGS.items():
        for key in configpars.get(section, {}) or {}:
            if key not in known:
                print(
                    f"WARNING: unrecognized key {key!r} in [{section}] is "
                    f"ignored (known keys: {', '.join(sorted(known))})."
                )


class SolverPlan(NamedTuple):
    """How a (solver, settings) combination maps onto the native sampler."""

    cfg: NSConfig
    #: equal-weight resample size (0 -> number of valid posterior samples)
    resample_S: int
    #: two-pass posterior-boost sampling (not ported)
    dynamic: bool
    #: PolyChord resume semantics (not ported)
    read_resume: bool = False
    write_resume: bool = False
    #: PolyChord ``_dead-birth.txt`` output (not ported)
    write_dead: bool = False


def build_model(configpars: Dict[str, Any], debug: bool = False) -> AbsorptionModel:
    """Instantiate the fit model from a run-params dict."""
    if configpars.get("atomfile"):
        load_atomfile(configpars["atomfile"])
    return AbsorptionModel.from_file(
        configpars["specfile"],
        fitrange=configpars["wavefit"],
        fitlines=configpars["linelist"],
        ncomp=configpars["ncomp"],
        nfill=configpars["nfill"],
        coldef=configpars["coldef"],
        contval=configpars["contval"],
        specres=configpars["specres"],
        Nrange=configpars["Nrange"],
        brange=configpars["brange"],
        zrange=configpars["zrange"],
        Nrangefill=configpars["Nrangefill"],
        brangefill=configpars["brangefill"],
        wrangefill=configpars["wrangefill"],
        Gpriors=configpars.get("gpriors"),
        Asymmlike=configpars["asymmlike"],
        debug=debug,
    )


def solver_nsconfig(configpars: Dict[str, Any], ndim: int) -> SolverPlan:
    """Map a solver name + its settings section onto the native sampler,
    with the per-solver defaults of :func:`mcalf_tpu.runner.solver_nsconfig`
    (polychord/dypolychord: nlive 100; multinest: nlive 1000, tolerance
    0.1; dynesty: nlive 500, dynamic; jaxns: nlive 500, max_samples 1e5);
    ``[ns_settings]`` overrides apply on top for any solver."""
    solver = configpars.get("solver", "polychord")
    if solver not in KNOWN_SOLVERS:
        raise ValueError(
            f"Requested solver {solver!r} not implemented; known: {KNOWN_SOLVERS}"
        )
    _warn_unknown_settings(configpars)

    nlive, num_repeats, precision = 100, 0, 1e-3
    max_samples, difficult = 20000, False
    num_delete = 0
    max_clusters = 8
    read_resume = write_resume = write_dead = False

    if solver in ("polychord", "dypolychord"):
        s = configpars.get("pc_settings", {})
        nlive = int(s.get("nlive", 100))
        num_repeats = int(s.get("num_repeats", 0))
        precision = float(s.get("precision_criterion", 1e-3))
        if not _as_bool(s.get("do_clustering", True), True):
            max_clusters = 1
        if s:
            # Reference defaults these True whenever [pc_settings] exists.
            read_resume = _as_bool(s.get("read_resume", True), True)
            write_resume = _as_bool(s.get("write_resume", True), True)
            write_dead = _as_bool(s.get("write_dead", True), True)
    elif solver == "multinest":
        s = configpars.get("mn_settings", {})
        nlive = int(s.get("nlive", 1000))
        precision = float(s.get("evidence_tolerance", 0.1))
    elif solver == "dynesty":
        nlive = 500
    elif solver == "jaxns":
        s = configpars.get("jaxns_settings", {})
        max_samples = int(float(s.get("max_samples", 1e5)))
        nlive = int(s.get("num_live_points", 500))
        difficult = _as_bool(s.get("difficult_model", False))

    s = configpars.get("ns_settings", {})
    nlive = int(s.get("nlive", nlive))
    num_repeats = int(s.get("num_repeats", num_repeats))
    num_delete = int(s.get("num_delete", num_delete))
    precision = float(s.get("precision_criterion", precision))
    max_samples = int(float(s.get("max_samples", max_samples)))
    difficult = _as_bool(s.get("difficult_model", difficult))
    max_clusters = int(s.get("max_clusters", max_clusters))
    bracket = str(s.get("bracket", "chord"))
    stepout_w = float(s.get("stepout_w", 2.0))
    stepout_budget = int(s.get("stepout_budget", 16))
    dynamic = _as_bool(
        s.get("dynamic", solver in ("dypolychord", "dynesty")), False
    )

    cfg = NSConfig(
        ndim=ndim,
        nlive=nlive,
        num_delete=num_delete,
        num_repeats=num_repeats,
        precision_criterion=precision,
        max_samples=max_samples,
        difficult_model=difficult,
        max_clusters=max_clusters,
        bracket=bracket,
        stepout_w=stepout_w,
        stepout_budget=stepout_budget,
    )
    resample_S = max_samples if solver == "jaxns" else 0
    return SolverPlan(
        cfg=cfg,
        resample_S=resample_S,
        dynamic=dynamic,
        read_resume=read_resume,
        write_resume=write_resume,
        write_dead=write_dead,
    )


def transdim_counts_as_difficult(cfg: NSConfig, model) -> bool:
    """An unset ``num_repeats`` on a trans-dimensional (variable-ncomp)
    model resolves to the doubled 24*ndim default (the JAX package's
    calibration: -1.66 +/- 0.66 nats at 8*ndim on the flagship)."""
    return (
        cfg.num_repeats == 0
        and not cfg.difficult_model
        and model.ncomp[0] != model.ncomp[1]
    )


def chain_basename(configpars: Dict[str, Any]) -> str:
    """``chaindir + chainfmt.format(nfill)`` (reference cli.py:293,324)."""
    return os.path.join(
        configpars["chaindir"], configpars["chainfmt"].format(configpars["nfill"])
    )


def resolve_device(configpars: Dict[str, Any]) -> torch.device:
    """``[run] device``: default/cuda[:N] -> a CUDA device (raises without
    one; there is no silent move to the CPU), cpu -> the CPU."""
    name = str(configpars.get("device", "default")).strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name == "default" or name.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"[run] device = {name} needs a CUDA GPU and torch finds none; "
                "set [run] device = cpu to fit on the CPU."
            )
        return torch.device("cuda" if name == "default" else name)
    raise ValueError(f"[run] device = {name!r}: expected default, cuda[:N] or cpu")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to mcalf_torch yet (ROADMAP Queue 1: {item}); "
        "run it with mcalf_tpu."
    )


def run_fit(
    configpars: Dict[str, Any],
    debug: bool = False,
    model: Optional[AbsorptionModel] = None,
) -> Tuple[NSResults, str]:
    """Run the fit and write `.stats` + `_equal_weights.txt`.

    Returns (NSResults as host numpy arrays, chain basename)."""
    if len(configpars.get("specfiles") or []) > 1:
        raise _not_ported("a multi-spectrum fit", "ncomp_grid and multi-spectrum")
    if configpars.get("ncomp_grid"):
        raise _not_ported("[run] ncomp_grid", "ncomp_grid and multi-spectrum")
    if configpars.get("seeds"):
        raise _not_ported("[run] seeds", "dynamic, merge, ladder and seeds")
    device = resolve_device(configpars)

    if model is None:
        model = build_model(configpars, debug=debug)
    fwd = make_torch_forward(model, device, gpriors=model.gpriors is not None)
    plan = solver_nsconfig(configpars, model.ndim)
    cfg, resample_S = plan.cfg, plan.resample_S
    if plan.dynamic:
        raise _not_ported("dynamic sampling", "dynamic, merge, ladder and seeds")
    if _as_bool(configpars.get("ns_settings", {}).get("auto_repeats", False)):
        raise _not_ported("[ns_settings] auto_repeats", "dynamic, merge, ladder and seeds")
    if configpars.get("checkpoint") or plan.read_resume or plan.write_resume:
        raise _not_ported(
            "checkpoint/resume ([run] checkpoint, [pc_settings] read_resume/"
            "write_resume)", "checkpoint/resume",
        )
    if plan.write_dead:
        raise _not_ported("[pc_settings] write_dead", "checkpoint/resume")

    if cfg.num_repeats == 0:
        if transdim_counts_as_difficult(cfg, model):
            cfg = dataclasses.replace(cfg, difficult_model=True)
        r = cfg.resolved()
        print(
            f"num_repeats unset -> calibrated default {r.num_repeats} "
            f"(= {'24' if cfg.difficult_model else '12'}*ndim at ndim="
            f"{model.ndim}"
            + (", trans-dimensional model counts as difficult"
               if cfg.difficult_model else "")
            + "); set [ns_settings] num_repeats to override."
        )
    layout = model.canon_layout()
    if layout is not None:
        cfg = dataclasses.replace(cfg, canon_layout=layout)

    if debug:
        r = cfg.resolved()
        print(
            f"[DEBUG]: native NS on {device} with nlive={cfg.nlive}, "
            f"num_repeats={r.num_repeats}, num_delete={r.num_delete}, "
            f"max_samples={cfg.max_samples}, "
            f"precision={cfg.precision_criterion}, ndim={model.ndim}"
        )

    seed = int(configpars.get("seed", 43))
    gen = torch.Generator(device=device).manual_seed(seed)

    def on_chunk(s):
        print(
            f"  step {s.step:5d}  n_dead={s.n_dead:6d}"
            f"  logZ={float(s.logz):.3f}  logX={float(s.logx):.2f}"
        )

    showprogress = bool(configpars.get("showprogress", False))
    t0 = datetime.datetime.now()
    res = nested_sample(
        fwd.loglike_cube, gen, cfg, device,
        on_chunk=on_chunk if showprogress else None,
    ).numpy()
    print("Execution time {}".format(datetime.datetime.now() - t0))
    if res.termination_reason != 0:
        print(
            "WARNING: sampler hit max_samples before the evidence converged; "
            "consider raising max_samples."
        )

    # Insertion-rank health check (Fowlie et al. 2020), always on: printed
    # on failure and recorded in the .stats file as comment lines.
    diag = insertion_rank_test(res, cfg)
    line = (
        f"insertion-rank KS p = {diag.p_value:.4f} "
        f"(blocks {diag.p_value_blocks:.4f}, n={diag.n})"
    )
    if debug:
        print(f"[DEBUG]: {line}")
    if diag.p_value < 0.01:
        print(
            f"WARNING: insertion-rank test FAILED (p = {diag.p_value:.4f} < "
            "0.01): replacements are under-decorrelated and the evidence may "
            "be biased; raise num_repeats (ns_settings) and re-run."
        )
        line += "  ** FAILED (p < 0.01) **"

    os.makedirs(configpars["chaindir"], exist_ok=True)
    base = chain_basename(configpars)
    write_stats(base + ".stats", float(res.logz), float(res.logzerr), [line])

    if debug and cfg.max_clusters > 1:
        from mcalf_torch.sampler import posterior_cluster_report

        rep = posterior_cluster_report(res, max_clusters=cfg.max_clusters)
        if rep.k > 1:
            print(f"[DEBUG]: posterior has {rep.k} modes:")
            for i in range(rep.k):
                print(
                    f"[DEBUG]:   mode {i}: mass {rep.mass[i]:.3f}  "
                    f"mean(u) {np.round(rep.mean_u[i], 3)}"
                )

    S = resample_S if resample_S > 0 else int(
        np.isfinite(res.log_posterior_weights).sum()
    )
    su, logl = resample_equal(torch.Generator().manual_seed(42), res, S)
    params = fwd.cube_to_params(torch.from_numpy(su).to(device))
    matrix = equal_weights_matrix(params.cpu().numpy().astype(np.float64), logl)
    write_equal_weights(base + "_equal_weights.txt", matrix)
    print(f"Saved results to {base}_equal_weights.txt")
    return res, base
