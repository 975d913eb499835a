"""Fit orchestration: config dict -> model -> sampler -> chain files.

Port of :mod:`mcalf_tpu.runner` on one device: every solver name the
reference accepts runs the same native nested sampler, its settings section
tuning it, and the fit writes ``.stats`` and ``_equal_weights.txt`` in the
reference formats (through the port's copy, :mod:`mcalf_torch.io.chains`).
All of the JAX runner's fits are here: a single fit with checkpoints
(``[run] checkpoint``, or PolyChord's ``read_resume``/``write_resume`` under
``<chain base>_resume/``) and ``_dead-birth.txt``; dynamic sampling
(``dypolychord``, ``dynesty``, ``[ns_settings] dynamic``); the repeats
ladder (``auto_repeats``); seed ensembles merged by birth contours (``[run]
seeds``); the fixed-k grid (``[run] ncomp_grid``); and several spectra
(``specfile`` as a list).  What the JAX runner shards over a device mesh
runs here as one fleet on the card (:mod:`mcalf_torch.parallel`): the seeds
of an ensemble, and the spectra of a list when they stack (no seeds, no
``ncomp_grid``, not dynamic, no ``auto_repeats``, no checkpoints); a member
writes the files its solo fit would, byte for byte.  Under a process group
of W > 1 processes (``torchrun``; :func:`mcalf_torch.parallel.init_distributed`)
such a fleet is split over the processes where its count divides W, as the
JAX runner shards it over its devices, and only rank 0 writes files.

``[run] device``: ``default`` (or ``cuda``/``cuda:N``) fits on the GPU and
raises when there is none; ``cpu`` is the explicit CPU choice.  A
checkpoint holds its generator's state and resumes only on the device type
it was written on.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mcalf_torch.atomic import load_atomfile
from mcalf_torch.io.chains import write_equal_weights, write_stats
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models.batched import pad_model_to_npix, stack_problems
from mcalf_torch.parallel import fit_stacked, make_mesh
from mcalf_torch.sampler import (
    NSConfig,
    NSResults,
    converged_sample,
    dynamic_sample,
    equal_weights_matrix,
    insertion_rank_test,
    merge_results,
    nested_sample,
    posterior_ess,
    resample_equal,
)
from mcalf_torch.sampler.nested import unstack_results
from mcalf_torch.utils.checkpoint import (
    latest_checkpoint,
    load_state,
    problem_fingerprint,
    prune_checkpoints,
    save_state,
)
from mcalf_torch.utils.profiling import phase_timer
from mcalf_torch.utils.rank import writes_files

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
    #: run the two-pass posterior-boost sampler (sampler/dynamic.py)
    dynamic: bool
    #: boost-pass NSConfig override (None -> same as cfg)
    boost_config: Optional[NSConfig] = None
    #: posterior-mass threshold seeding the boost pass (dynamic.py)
    boost_start_mass: float = 0.01
    #: PolyChord resume semantics: resume from / write sampler-state
    #: checkpoints under ``<chain base>_resume/``
    read_resume: bool = False
    write_resume: bool = False
    #: write a PolyChord/anesthetic-style ``_dead-birth.txt`` file
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
    ``[ns_settings]`` overrides apply on top for any solver.

    ``dynamic`` selects the two-pass posterior-boost sampler: on by default
    for dypolychord and dynesty, or forced either way with ``[ns_settings]
    dynamic``.  ``[pc_settings] dynamic_goal`` maps onto ``boost_start_mass
    = 0.01 * goal``; ``[ns_settings] boost_nlive / boost_num_repeats /
    boost_max_samples`` tune the boost pass apart from the base pass.
    ``read_resume``/``write_resume``/``write_dead`` default True whenever
    ``[pc_settings]`` exists, as in the reference."""
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
    boost_start_mass = 0.01

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
        if "dynamic_goal" in s:
            boost_start_mass = 0.01 * float(s["dynamic_goal"])
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
    boost_start_mass = float(s.get("boost_start_mass", boost_start_mass))

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
    # Boost-pass overrides ([ns_settings] boost_*): tune the posterior-boost
    # run independently of the base run.
    boost_config = None
    if any(k in s for k in ("boost_nlive", "boost_num_repeats", "boost_max_samples")):
        boost_config = dataclasses.replace(
            cfg,
            nlive=int(s.get("boost_nlive", nlive)),
            num_repeats=int(s.get("boost_num_repeats", num_repeats)),
            max_samples=int(float(s.get("boost_max_samples", max_samples))),
        )
    resample_S = max_samples if solver == "jaxns" else 0
    return SolverPlan(
        cfg=cfg,
        resample_S=resample_S,
        dynamic=dynamic,
        boost_config=boost_config,
        boost_start_mass=boost_start_mass,
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




def _physical(fwd, samples_u) -> np.ndarray:
    """Unit-cube rows (host numpy) -> physical parameters (float64 numpy),
    through the forward model on its own device."""
    device = next(fwd.buffers()).device
    u = torch.from_numpy(np.ascontiguousarray(samples_u, dtype=np.float32))
    return fwd.cube_to_params(u.to(device)).cpu().numpy().astype(np.float64)


def _sampler_configs(configpars, model, device, debug=False):
    """(SolverPlan, NSConfig, boost NSConfig or None) of a fit of ``model``:
    the solver's settings, the calibrated default repeats and the
    label-symmetry gauge fixing."""
    plan = solver_nsconfig(configpars, model.ndim)
    cfg, boost_cfg = plan.cfg, plan.boost_config
    if cfg.num_repeats == 0:
        if transdim_counts_as_difficult(cfg, model):
            cfg = dataclasses.replace(cfg, difficult_model=True)
            if boost_cfg is not None and boost_cfg.num_repeats == 0:
                boost_cfg = dataclasses.replace(boost_cfg, difficult_model=True)
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
        # Label-symmetry gauge fixing (see NSConfig.canon_layout), in both
        # passes of a dynamic run.
        cfg = dataclasses.replace(cfg, canon_layout=layout)
        if boost_cfg is not None:
            boost_cfg = dataclasses.replace(boost_cfg, canon_layout=layout)

    if debug:
        r = cfg.resolved()
        print(
            f"[DEBUG]: native NS on {device} with nlive={cfg.nlive}, "
            f"num_repeats={r.num_repeats}, num_delete={r.num_delete}, "
            f"max_samples={cfg.max_samples}, "
            f"precision={cfg.precision_criterion}, ndim={model.ndim}, "
            f"dynamic={plan.dynamic}"
        )
    return plan, cfg, boost_cfg


def run_fit(
    configpars: Dict[str, Any],
    debug: bool = False,
    model: Optional[AbsorptionModel] = None,
) -> Tuple[NSResults, str]:
    """Run the fit and write `.stats` + `_equal_weights.txt`.

    Returns (NSResults as host numpy arrays, chain basename); for a seed
    ensemble the first is the MergedRun, and for several spectra the return
    is the list of those pairs, one per spectrum."""
    specfiles = configpars.get("specfiles") or []
    if len(specfiles) > 1 and model is None:
        return _run_spectrum_fleet(configpars, debug=debug)

    if configpars.get("ncomp_grid"):
        return _run_ncomp_grid(configpars, debug=debug)

    device = resolve_device(configpars)

    if model is None:
        model = build_model(configpars, debug=debug)
    fwd = make_torch_forward(model, device, gpriors=model.gpriors is not None)
    plan, cfg, boost_cfg = _sampler_configs(configpars, model, device, debug)
    resample_S, dynamic = plan.resample_S, plan.dynamic

    seeds_list = configpars.get("seeds")
    if seeds_list:
        if dynamic:
            raise ValueError(
                "[run] seeds (seed-ensemble) and dynamic sampling cannot be "
                "combined; drop one of the two."
            )
        if configpars.get("checkpoint"):
            print(
                "WARNING: [run] checkpoint is not supported with [run] "
                "seeds; the ensemble runs without checkpoints."
            )
        return _run_seed_ensemble(
            configpars, model, fwd, cfg, seeds_list, resample_S, device, debug=debug
        )

    seed = int(configpars.get("seed", 43))
    ckpt_dir = configpars.get("checkpoint")
    # An explicit [run] checkpoint dir both reads and writes.  Without one,
    # the PolyChord resume keys drive the same machinery under
    # <chain base>_resume/: write_resume saves rolling sampler-state
    # checkpoints, read_resume resumes from them.
    ckpt_read = ckpt_write = ckpt_dir is not None
    ckpt_implicit = False
    if ckpt_dir is None and (plan.read_resume or plan.write_resume):
        ckpt_dir = chain_basename(configpars) + "_resume"
        ckpt_read, ckpt_write = plan.read_resume, plan.write_resume
        # read_resume defaults ON whenever [pc_settings] exists, so stale
        # resume files from an EDITED config must not abort the run -- warn
        # and refit instead.  The explicit [run] checkpoint surface keeps the
        # hard fingerprint refusal.
        ckpt_implicit = True
    showprogress = bool(configpars.get("showprogress", False))
    # [ns_settings] auto_repeats: run the repeats LADDER (sampler/repeats.py)
    # instead of a single fit -- double num_repeats until one doubling moves
    # the evidence by less than its combined uncertainty with green rank
    # tests, then report the final rung's 2 seeds birth-merged.
    auto_repeats = _as_bool(
        configpars.get("ns_settings", {}).get("auto_repeats", False)
    )
    if auto_repeats and dynamic:
        raise ValueError(
            "[ns_settings] auto_repeats and dynamic sampling cannot be "
            "combined (set dynamic = false, or drop auto_repeats)."
        )
    if auto_repeats and ckpt_dir:
        print(
            "WARNING: checkpoints/resume are not supported with "
            "auto_repeats; the ladder runs without them."
        )
        ckpt_dir = None
        ckpt_read = ckpt_write = False

    t0 = datetime.datetime.now()
    # Chunked stepping is always on (a resumed run meets the boundaries of
    # the uninterrupted one); checkpoints and progress hang off the
    # per-chunk callback.
    state = None
    boost_state = None
    fp = problem_fingerprint(model, cfg, seed, device) if ckpt_dir else None

    def _load_resume(path, what):
        # The fingerprint check refuses checkpoints of a different problem /
        # sampler config / seed / generator device type (same-shape states
        # would otherwise resume silently into a wrong run).  On the IMPLICIT
        # pc-resume surface a mismatch means the config or data were edited
        # since the stale files were written: warn and refit fresh.
        print(f"Resuming {what}from checkpoint {path}")
        try:
            return load_state(path, fingerprint=fp, device=device)
        except ValueError:
            if not ckpt_implicit:
                raise
            print(
                f"WARNING: stale resume files in {ckpt_dir} do not "
                "match this problem/config/seed/device type (config edited "
                "since they were written?); starting a fresh fit.  Delete "
                "the directory or set [pc_settings] read_resume = "
                "False to silence this."
            )
            return None

    if ckpt_read:
        prev = latest_checkpoint(ckpt_dir)
        if prev is not None:
            state = _load_resume(prev, "")
        # a stale (mismatched) base state means the boost files are
        # equally stale -- skip them and refit fresh
        if dynamic and (prev is None or state is not None):
            prevb = latest_checkpoint(ckpt_dir, prefix="ns_boost")
            if prevb is not None:
                boost_state = _load_resume(prevb, "boost pass ")

    def make_on_chunk(prefix, tag=""):
        def on_chunk(s):
            if showprogress:
                print(
                    f"  {tag}step {s.step:5d}  n_dead={s.n_dead:6d}"
                    f"  logZ={float(s.logz):.3f}  logX={float(s.logx):.2f}"
                )
            # every rank of a process group runs a fit that is not split,
            # on the same paths: rank 0 alone writes and prunes them
            if ckpt_write and writes_files():
                save_state(
                    os.path.join(ckpt_dir, f"{prefix}_{s.step:06d}.npz"),
                    s,
                    fingerprint=fp,
                )
                prune_checkpoints(ckpt_dir, keep=3, prefix=prefix)

        return on_chunk

    with phase_timer("nested_sampling"):
        want_cb = bool(ckpt_write or showprogress)
        gen = torch.Generator(device=device).manual_seed(seed)
        if dynamic:
            # Two-pass posterior-boost sampling (sampler/dynamic.py) -- the
            # dyPolyChord analogue.  Both passes checkpoint and report through
            # the same chunked machinery (base under the ns_state prefix, boost
            # under ns_boost); a kill mid-boost resumes past the (terminal) base
            # checkpoint into the boost pass.
            dyn = dynamic_sample(
                fwd.loglike_cube,
                gen,
                cfg,
                device,
                boost_config=boost_cfg,
                boost_start_mass=plan.boost_start_mass,
                base_state=state,
                boost_state=boost_state,
                on_chunk_base=make_on_chunk("ns_state") if want_cb else None,
                on_chunk_boost=(
                    make_on_chunk("ns_boost", tag="boost ") if want_cb else None
                ),
            )
            res, post = dyn.base, dyn.merged
            runs = [("", dyn.base, cfg), ("boost ", dyn.boost, boost_cfg or cfg)]
            if debug:
                print(
                    f"[DEBUG]: dynamic boost above lnL={dyn.l_init:.3f}; "
                    f"posterior ESS {posterior_ess(dyn.base.log_posterior_weights):.0f}"
                    f" -> {posterior_ess(dyn.merged.log_posterior_weights):.0f}"
                )
        elif auto_repeats:
            conv = converged_sample(
                fwd.loglike_cube,
                seed,
                cfg,
                device,
                seeds=2,
                verbose=debug or showprogress,
            )
            res, post = conv.results[0], conv.merged
            # Every ladder seed feeds the merged evidence, so every one gets a
            # recorded verdict (not just the first).
            runs = [(f"seed{i} ", r, cfg) for i, r in enumerate(conv.results)]
            rungs = [r.num_repeats for r in conv.ladder]
            if conv.converged:
                print(
                    f"auto_repeats: evidence converged at num_repeats="
                    f"{conv.num_repeats} (ladder {rungs})"
                )
            else:
                print(
                    "WARNING: auto_repeats ladder budget exhausted at "
                    f"num_repeats={conv.num_repeats} (ladder {rungs}) "
                    "without meeting the doubling criterion; treat the "
                    "evidence as a lower-confidence estimate or raise "
                    "max_doublings/num_repeats."
                )
        else:
            res = nested_sample(
                fwd.loglike_cube, gen, cfg, device,
                state=state,
                on_chunk=make_on_chunk("ns_state") if want_cb else None,
            ).numpy()
            post = res
            runs = [("", res, cfg)]
            if debug and state is None:
                print(f"[DEBUG]: seed {seed}: logZ = {float(res.logz):.3f}"
                      f"{_row_counts(gen, res, cfg)}")
    print("Execution time {}".format(datetime.datetime.now() - t0))

    stats_extra = []
    if auto_repeats:
        stats_extra.append(
            f"auto_repeats ladder converged={conv.converged} "
            f"(rungs {rungs}, final num_repeats={conv.num_repeats})"
            + ("" if conv.converged else "  ** BUDGET EXHAUSTED **")
        )
    base = _write_fit(configpars, fwd, post, runs, plan, cfg, stats_extra, debug)
    return res, base


def _write_fit(configpars, fwd, post, runs, plan, cfg, stats_extra, debug):
    """The files of one fit: the max_samples warning, the insertion-rank
    verdict of every run that feeds the evidence (into the .stats file
    after ``stats_extra``), `.stats` + `_equal_weights.txt` of ``post``,
    `_dead-birth.txt` where the plan asks for it, and under ``debug`` the
    first run's diagnostics figure in plotdir.  ``runs`` are (tag,
    NSResults as host numpy arrays, NSConfig).  Returns the chain
    basename."""
    if any(r.termination_reason != 0 for _, r, _ in runs):
        print(
            "WARNING: sampler hit max_samples before the evidence converged; "
            "consider raising max_samples."
        )

    # Insertion-rank health check (Fowlie et al. 2020) on every run that
    # feeds the evidence, always on: an under-decorrelated run completes
    # silently with a plausible-looking but biased evidence.  The verdict
    # goes to stdout AND into the .stats file as comment lines.
    stats_extra = list(stats_extra)
    for tag, r, run_cfg in runs:
        diag = insertion_rank_test(r, run_cfg)
        line = (
            f"insertion-rank KS p = {diag.p_value:.4f} "
            f"(blocks {diag.p_value_blocks:.4f}, n={diag.n})"
        )
        if debug:
            print(f"[DEBUG]: {tag}{line}")
        if diag.p_value < 0.01:
            print(
                f"WARNING: {tag}insertion-rank test FAILED (p = "
                f"{diag.p_value:.4f} < 0.01): replacements are "
                "under-decorrelated and the evidence may be biased; raise "
                "num_repeats (ns_settings) and re-run."
            )
            line += "  ** FAILED (p < 0.01) **"
        stats_extra.append(tag + line)

    os.makedirs(configpars["chaindir"], exist_ok=True)
    base = chain_basename(configpars)
    _write_chain_files(base, fwd, post, plan.resample_S, stats_extra)
    if plan.write_dead:
        # Dynamic solvers merge base+boost into .stats/_equal_weights, so the
        # dead-birth file carries BOTH passes too: anesthetic reconstructs
        # the run from (logL, birth-logL) pairs, and a base-only file would
        # re-analyze to a different evidence than the shipped outputs.
        _write_dead_birth(base + "_dead-birth.txt", fwd, *(r for _, r, _ in runs))

    if debug and cfg.max_clusters > 1:
        # Per-mode posterior readout: mass fraction + mean per mode.
        from mcalf_torch.sampler import posterior_cluster_report

        rep = posterior_cluster_report(post, max_clusters=cfg.max_clusters)
        if rep.k > 1:
            print(f"[DEBUG]: posterior has {rep.k} modes:")
            for i in range(rep.k):
                print(
                    f"[DEBUG]:   mode {i}: mass {rep.mass[i]:.3f}  "
                    f"mean(u) {np.round(rep.mean_u[i], 3)}"
                )
    if debug and writes_files():
        # Sampler-diagnostics figure of the run the evidence starts from
        # (the rank verdict is printed above).
        from mcalf_torch.plotting import plot_diagnostics

        png = os.path.join(
            configpars.get("plotdir", configpars["chaindir"]),
            configpars["chainfmt"].format(configpars["nfill"]) + "_diagnostics.png",
        )
        plot_diagnostics(runs[0][1], runs[0][2], png)

    print(f"Saved results to {base}_equal_weights.txt")
    return base


def _write_dead_birth(path, fwd, *runs):
    """PolyChord-format ``_dead-birth.txt`` (the reference's ``write_dead``
    output): one row per dead point -- physical parameters, logL,
    birth-contour logL -- the file anesthetic's ``read_polychord`` consumes,
    so downstream nested-sampling tooling works on these chains unchanged.
    Prior-born points get PolyChord's -1e30 birth sentinel instead of -inf.
    Several runs (a dynamic base+boost pair) concatenate: per-point birth
    contours are the canonical representation of a merged/dynamic run.
    ``runs`` hold host numpy arrays.  Rank 0 alone writes."""
    if not writes_files():
        return
    rows = []
    for res in runs:
        valid = np.isfinite(np.asarray(res.logw, np.float64))
        params = _physical(fwd, np.asarray(res.samples_u)[valid])
        logl = np.asarray(res.logl, np.float64)[valid]
        birth = np.asarray(res.birth_logl, np.float64)[valid]
        birth = np.where(np.isfinite(birth), birth, -1e30)
        rows.append(np.column_stack([params, logl, birth]))
    np.savetxt(path, np.concatenate(rows, axis=0))


def _write_chain_files(base, fwd, post, resample_S, extra_lines=()):
    """Write one `.stats` + `_equal_weights.txt` pair for any posterior
    carrier (NSResults as host numpy arrays, or a MergedRun); rank 0 of a
    multi-process run alone writes."""
    if not writes_files():
        return
    with phase_timer("runner.files"):
        write_stats(base + ".stats", float(post.logz), float(post.logzerr), extra_lines)
        S = resample_S if resample_S > 0 else int(
            np.isfinite(post.log_posterior_weights).sum()
        )
        su, logl = resample_equal(torch.Generator().manual_seed(42), post, S)
        write_equal_weights(
            base + "_equal_weights.txt", equal_weights_matrix(_physical(fwd, su), logl)
        )


def _fleet_mesh(count: int, device) -> list:
    """The mesh a fleet of ``count`` problems runs on: one entry per process
    of a process group of W > 1 processes where W divides ``count`` (the
    JAX runner's condition for its device mesh), else ``device`` alone."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1 and count % world == 0:
        return make_mesh([device])
    return [device]


def _run_seed_ensemble(configpars, model, fwd, cfg, seeds, resample_S, device, debug=False):
    """Seed-ensemble fit through the config surface (``[run] seeds``).

    The same problem is fit once per seed, all seeds together as one fleet
    (:func:`mcalf_torch.parallel.fit_stacked`: one fused-kernel launch per
    slice iteration for every seed), seed s drawing from
    ``manual_seed(s)``, so each member is bit for bit the solo fit with
    ``[run] seed = s``; then the members are birth-contour merged
    (sampler/merge.py) into ONE evidence with a sqrt(K)-smaller,
    simulated-weights error bar.  Per-member chain files get a ``_s<seed>``
    suffix on the ``chainfmt.format(nfill)`` base; the merged posterior
    lands under the base name so the analysis/plot phase works
    unchanged.  Under a process group the seeds are split over the
    processes (:func:`_fleet_mesh`); every process gets every member."""
    t0 = datetime.datetime.now()
    spec, stacked = stack_problems(
        [model] * len(seeds), gpriors=model.gpriors is not None
    )
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    mesh = _fleet_mesh(len(seeds), device)
    if debug:
        where = f"{len(mesh)} processes" if len(mesh) > 1 else str(device)
        print(f"[DEBUG]: {len(seeds)} seeds as one fleet on {where}")
    with phase_timer("nested_sampling"):
        batched = fit_stacked(spec, stacked, cfg, mesh=mesh, generators=gens)
        runs = [r.numpy() for r in unstack_results(batched)]
    if debug:
        for s, res, g in zip(seeds, runs, gens):
            print(f"[DEBUG]: seed {s}: logZ = {float(res.logz):.3f}{_row_counts(g, res, cfg)}")
    print("Execution time {}".format(datetime.datetime.now() - t0))

    with phase_timer("runner.merge"):
        merged = merge_results(runs)
    os.makedirs(configpars["chaindir"], exist_ok=True)
    base = chain_basename(configpars)
    stats_extra = []
    unconv = False
    for s, r in zip(seeds, runs):
        diag = insertion_rank_test(r, cfg)
        line = (
            f"seed {s}: logZ = {float(r.logz):.3f} +/- "
            f"{float(r.logzerr):.3f}; insertion-rank KS p = {diag.p_value:.4f}"
        )
        if diag.p_value < 0.01:
            print(
                f"WARNING: seed {s} insertion-rank test FAILED "
                f"(p = {diag.p_value:.4f} < 0.01); raise num_repeats."
            )
            line += "  ** FAILED (p < 0.01) **"
        stats_extra.append(line)
        unconv |= r.termination_reason != 0
        _write_chain_files(f"{base}_s{s}", fwd, r, resample_S)
    if unconv:
        print(
            "WARNING: at least one ensemble member hit max_samples before "
            "converging; consider raising max_samples."
        )
    spread = max(float(r.logz) for r in runs) - min(
        float(r.logz) for r in runs
    )
    stats_extra.append(
        f"merged {len(seeds)} seeds {list(seeds)} by birth contours; "
        f"seed spread = {spread:.3f}"
    )
    _write_chain_files(base, fwd, merged, resample_S, stats_extra)
    print(f"Saved merged ensemble results to {base}_equal_weights.txt")
    return merged, base


def _row_counts(gen, res, cfg) -> str:
    """The ``--debug`` reading of the slice loop's row counters for the run
    that drew from ``gen`` (counting is on under ``--debug``): proposals
    per slice pass, and the share of the rows its likelihood calls
    evaluated for chains that had no pass to make."""
    from mcalf_torch.sampler.graph import generator_rows

    got = generator_rows(gen)
    if not got or not got[0] or not res.n_iter:
        return ""
    rows, active = got
    cfg = cfg.resolved()
    passes = int(res.n_iter) * cfg.num_repeats * cfg.num_delete
    return (f"; {active / passes:.3f} proposals per slice pass, "
            f"{100.0 * (1.0 - active / rows):.2f}% of {rows} rows masked")


def _write_ncomp_table(path, rows) -> int:
    """The ``ncomp_grid`` Bayes-factor table: per-k logZ, its error and
    Delta logZ against the best k, then the uniform-prior trans-dimensional
    evidence logsumexp(logZ_k) - log K.  ``rows`` are (k, logZ, logZerr).
    Returns the index of the best row."""
    logzs = np.array([r[1] for r in rows])
    best = int(np.argmax(logzs))
    m = logzs.max()
    logz_trans = m + np.log(np.exp(logzs - m).sum()) - np.log(len(rows))
    if not writes_files():
        return best
    with open(path, "w") as f:
        f.write("# k  logZ  logZerr  dlogZ_vs_best\n")
        for k, lz, le in rows:
            f.write(f"{k}  {lz:.4f}  {le:.4f}  {lz - logzs[best]:+.4f}\n")
        f.write(
            f"# best k = {rows[best][0]}; trans-dimensional evidence "
            f"(uniform k prior) = {logz_trans:.4f}\n"
        )
    return best


def _run_ncomp_grid(configpars, debug=False):
    """Fixed-k model grid through the config surface (``[run] ncomp_grid``).

    One fixed-ncomp fit per k in the configured [components] ncomp range
    (each through the full run_fit flow under a ``_k<k>`` chain suffix, with
    its own model and device constants), then the Bayes-factor table.  The
    best-k chain files are copied to the base name so the analysis / plot
    phase picks the selected model (the reference workflow's evidence-based
    ncomp selection as one command)."""
    lo, hi = int(configpars["ncomp"][0]), int(configpars["ncomp"][1])
    base = chain_basename(configpars)
    fits = []
    for k in range(lo, hi + 1):
        sub = dict(
            configpars,
            ncomp=np.array([k, k]),
            ncomp_grid=False,
            chainfmt=configpars["chainfmt"] + f"_k{k}",
        )
        print(f"--- ncomp grid: fitting fixed k = {k} ---")
        res, kbase = run_fit(sub, debug=debug)
        fits.append((k, res, kbase))

    os.makedirs(configpars["chaindir"], exist_ok=True)
    table = base + "_ncomp_grid.txt"
    best = _write_ncomp_table(
        table, [(k, float(res.logz), float(res.logzerr)) for k, res, _ in fits]
    )
    k, res, kbase = fits[best]
    print(f"ncomp grid: best k = {k} "
          f"(logZ = {float(res.logz):.3f}); table in {table}")
    for suffix in (".stats", "_equal_weights.txt"):
        if writes_files() and os.path.exists(kbase + suffix):
            shutil.copyfile(kbase + suffix, base + suffix)
    # The best-k RESULTS (not the bare k): callers rely on run_fit's declared
    # return.  The selected k is in the table and the `_k<k>` chain files.
    return res, base


def spectrum_subconfigs(configpars: Dict[str, Any]):
    """Per-spectrum sub-configs for a multi-sightline run (``specfile`` as
    a comma list / glob in the config).  Each spectrum gets a
    ``_<filestem>`` chain/plot suffix (disambiguated on collision) and,
    when checkpointing, its own checkpoint subdirectory (the problem
    fingerprint would refuse cross-spectrum resumes anyway)."""
    specfiles = configpars.get("specfiles") or [configpars["specfile"]]
    seen: Dict[str, int] = {}
    subs = []
    for sf in specfiles:
        stem = os.path.splitext(os.path.basename(sf))[0]
        if stem in seen:
            seen[stem] += 1
            stem = f"{stem}{seen[stem]}"
        else:
            seen[stem] = 0
        sub = dict(
            configpars,
            specfile=sf,
            specfiles=[sf],
            chainfmt=configpars["chainfmt"] + "_" + stem,
        )
        if configpars.get("checkpoint"):
            sub["checkpoint"] = os.path.join(configpars["checkpoint"], stem)
        subs.append(sub)
    return subs


def _run_spectrum_fleet(configpars, debug=False):
    """Multi-sightline fit through the config surface (``specfile`` list).

    Every spectrum is fit with the same settings.  When the problems stack
    (the same structure once padded at the red end to one pixel count) and
    the fit is a plain one -- no seeds, no ``ncomp_grid``, not dynamic, no
    ``auto_repeats``, no checkpoints (``[run] checkpoint`` or a
    ``[pc_settings]`` resume), whose per-spectrum files the fleet would not
    write -- they run as one fleet (:func:`mcalf_torch.parallel.fit_stacked`),
    each spectrum on a generator seeded with ``[run] seed`` as its solo fit
    is; a spectrum on the common grid then writes its solo fit's files byte
    for byte.  Otherwise each runs through the full single-spectrum
    ``run_fit`` flow, one after another.  Returns the list of per-spectrum
    (results, chain basename) pairs."""
    subs = spectrum_subconfigs(configpars)
    probe = solver_nsconfig(configpars, 1)
    auto_repeats = _as_bool(configpars.get("ns_settings", {}).get("auto_repeats", False))
    plain = not (
        configpars.get("seeds") or configpars.get("ncomp_grid") or probe.dynamic
        or auto_repeats or configpars.get("checkpoint")
        or probe.read_resume or probe.write_resume
    )
    if plain:
        models = [build_model(sub, debug=debug) for sub in subs]
        npix = max(m.npix for m in models)
        gpriors = models[0].gpriors is not None
        try:
            spec, stacked = stack_problems(
                [pad_model_to_npix(m, npix) for m in models], gpriors=gpriors
            )
        except ValueError as e:
            print(f"NOTE: spectra do not stack for one fleet ({e}); fitting sequentially.")
        else:
            return _fit_spectra_stacked(configpars, subs, models, spec, stacked, debug)

    out = []
    for sub in subs:
        print(f"--- fitting {sub['specfile']} ---")
        out.append(run_fit(sub, debug=debug))
    return out


def _fit_spectra_stacked(configpars, subs, models, spec, stacked, debug):
    """The spectra of ``subs`` (their models, stacked) as one fleet, then
    each spectrum's files as its solo fit writes them."""
    device = resolve_device(configpars)
    plan, cfg, _ = _sampler_configs(configpars, models[0], device, debug)
    seed = int(configpars.get("seed", 43))
    for sub in subs:
        print(f"--- fitting {sub['specfile']} (one fleet of {len(subs)} spectra on {device}) ---")
    gens = [torch.Generator(device=device).manual_seed(seed) for _ in subs]
    mesh = _fleet_mesh(len(subs), device)
    if debug and len(mesh) > 1:
        print(f"[DEBUG]: {len(subs)} spectra split over {len(mesh)} processes")
    t0 = datetime.datetime.now()
    with phase_timer("nested_sampling"):
        batched = fit_stacked(spec, stacked, cfg, mesh=mesh, generators=gens)
    print("Execution time {}".format(datetime.datetime.now() - t0))
    out = []
    for sub, m, res in zip(subs, models, unstack_results(batched)):
        res = res.numpy()
        fwd = make_torch_forward(m, device, gpriors=m.gpriors is not None)
        base = _write_fit(sub, fwd, res, [("", res, cfg)], plan, cfg, [], debug)
        out.append((res, base))
    return out
