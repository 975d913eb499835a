"""The benchmark's cells as data, and the loop that runs the fits they time.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a file of its own, found by its name:

* ``benchmark/configs/<config>.json``: the ``.cfg`` it starts from and
  the spectrum it reads (paths from the repository root, each pinned by
  its SHA-256, so that the configuration cannot move under the benchmark),
  and the keys the benchmark changes (``section.option``: value;
  ``outdir`` and ``datadir`` are set per fit);
* ``benchmark/traffic/<traffic>.json``: ``seeds_per_fit`` (the fleet of
  ``[run] seeds`` each fit runs), ``bracket`` and, optionally,
  ``resume_at``: every fit of the run then resumes, as ``[run]
  checkpoint`` does, from the state the fitter saved at that many dead
  points (a chunk boundary of its sampler) in the run's set-up
  (:meth:`Bench.checkpoint`), so the run measures a fit's later phase;
* ``benchmark/metrics/<metric>.py``: ``read(record)``, the metric's value
  from the run's record, or None where it finds nothing to read;
* ``benchmark/limits/<workload>.json``: the limit of each number that the
  correctness comparison reads (:mod:`benchmark.check`).

:class:`Bench` runs one fit of a cell through the fitter's command-line
entry (``mcalf_torch.cli.main`` on a written ``.cfg``: ``runner.run_fit``,
the seed ensemble as one stacked fleet, the merge and the chain files; with
``resume_at``, a fresh copy of the set-up's checkpoint) and records around
it what the fitter exposes: its ``nested_sampling`` phase
span, the kernels' launch counters, the captured loop's counters, the
rows of each likelihood call (counted as the card runs them), and the
per-seed runs the runner merged.
"""

from __future__ import annotations

import configparser
import contextlib
import hashlib
import importlib.util
import io
import json
import shutil
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    metrics and limits."""

    def __init__(self, workload: str, bench: Optional[dict] = None):
        bench = bench or manifest()
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        self.chips = int(self.workload["chips"])
        self.config = json.loads((HERE / "configs" / f"{self.workload['config']}.json").read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
        self.seeds_per_fit = int(self.traffic["seeds_per_fit"])
        self.resume_at = int(self.traffic.get("resume_at", 0))
        if self.resume_at and self.seeds_per_fit != 1:
            raise ValueError("resume_at needs seeds_per_fit 1: the fitter resumes one seed a fit")
        self.cfg_source = _pinned(self.config["cfg"], self.config["cfg_sha256"])
        self.datadir = _pinned(self.config["spectrum"], self.config["spectrum_sha256"]).parent

        def applies(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def write_cfg(self, outdir: Path, seeds: List[int], max_samples: Optional[int] = None,
                  extra: Optional[Dict[str, str]] = None) -> Path:
        """The cell's ``.cfg`` for one fit under ``outdir``: the source with
        the configuration's changes, the traffic's fleet and bracket, and
        ``extra`` (``section.option``: value) on top."""
        cp = configparser.ConfigParser()
        cp.read(self.cfg_source)
        changes = dict(self.config["changes"])
        changes.update({
            "pathing.outdir": f"{outdir}/",
            "pathing.datadir": f"{self.datadir}/",
            "ns_settings.bracket": self.traffic["bracket"],
        })
        if max_samples is not None:
            for k in [k for k in changes if k.endswith(".max_samples")]:
                changes[k] = str(max_samples)
        if len(seeds) > 1:
            changes["run.seeds"] = ",".join(str(s) for s in seeds)
        else:
            changes["run.seed"] = str(seeds[0])
        changes.update(extra or {})
        for key, value in changes.items():
            section, option = key.split(".", 1)
            if not cp.has_section(section):
                cp.add_section(section)
            cp.set(section, option, str(value))
        outdir.mkdir(parents=True, exist_ok=True)
        path = outdir / "fit.cfg"
        with open(path, "w") as fh:
            cp.write(fh)
        return path

    def cap(self, cfg_path: Path) -> int:
        """The ``max_samples`` a written ``.cfg`` caps its fits at."""
        cp = configparser.ConfigParser()
        cp.read(cfg_path)
        [key] = [k for k in self.config["changes"] if k.endswith(".max_samples")]
        return cp.getint(*key.split(".", 1))

    def chain_base(self, cfg_path: Path) -> str:
        cp = configparser.ConfigParser()
        cp.read(cfg_path)
        outdir = cp.get("pathing", "outdir")
        chaindir = cp.get("pathing", "chaindir", fallback="fits/")
        fmt = cp.get("pathing", "chainfmt", fallback="pc_fits_{0}")
        return outdir + chaindir + fmt.format(cp.getint("components", "nfill", fallback=0))


#: the fits of a run that draw their seeds from ``--seed``
ROLES = ("window", "warm-up", "profiled", "resume")


def fit_seeds(seed: int, role: str, k: int, count: int) -> List[int]:
    """The generator seeds of fit ``k`` of ``role`` in a run with ``--seed
    seed``."""
    entropy = [seed & (2**64 - 1), ROLES.index(role), k]
    state = np.random.SeedSequence(entropy).generate_state(count, np.uint32)
    return [int(s) for s in state]




def _pinned(relpath: str, sha256: str) -> Path:
    """A file of the repository that a configuration reads, refused unless
    its bytes are the ones the configuration was measured with."""
    path = ROOT / relpath
    got = hashlib.sha256(path.read_bytes()).hexdigest()
    if got != sha256:
        raise ValueError(f"{relpath} has changed (SHA-256 {got}, the configuration pins {sha256})")
    return path


class Resume(NamedTuple):
    """The checkpoint a cell's fits resume from: the fit's seed, the
    directory that holds the fitter's saved state, and what that state had
    done (dead points, likelihood evaluations, and the dead points' unit-cube
    rows and log L, host numpy)."""

    seed: int
    directory: Path
    n_dead: int
    n_like: int
    dead_u: np.ndarray
    dead_logl: np.ndarray


class _Saved(Exception):
    """Ends the set-up's fit once its state at ``resume_at`` is saved."""


class SetupFailed(Exception):
    """The program failed in a run's set-up, so the run is not correct."""


class FitRecord:
    """What one fit did: walls, counters, runs and where its files are.
    ``dead`` and ``n_like`` count what the fit added to its checkpoint's."""

    def __init__(self, seeds):
        self.seeds = list(seeds)
        self.wall_s = self.ns_s = 0.0
        self.calls = self.n_like = self.dead = self.captures = 0
        self.capture_s = 0.0
        self.row_counts: Counter = Counter()
        self.runs: list = []
        self.base: Optional[str] = None
        self.error: Optional[str] = None
        self.output = ""


class Bench:
    """Runs fits of a cell through ``mcalf_torch.cli.main`` and records
    around each what the fitter exposes (see the module docstring)."""

    def __init__(self, cell: Cell, workdir: Path):
        self.cell, self.workdir = cell, workdir
        self.resume: Optional[Resume] = None
        self._captured: list = []
        self._rows: Counter = Counter()
        _install_spies(self)

    def checkpoint(self, seed: int, extra: Optional[Dict[str, str]] = None) -> Resume:
        """Run the cell's fit with ``seed`` through the fitter's own
        functions, as its runner does for one seed (the model, the forward,
        the sampler's configuration, ``nested_sample`` with a callback at
        each chunk boundary), save the state at ``resume_at`` dead points
        under the runner's fingerprint, as ``[run] checkpoint`` saves it, and
        stop there.  Every later fit of this bench resumes from a copy."""
        import torch

        from mcalf_torch import runner
        from mcalf_torch.config import readconfig
        from mcalf_torch.sampler.nested import nested_sample
        from mcalf_torch.utils.checkpoint import problem_fingerprint, save_state

        at = self.cell.resume_at
        home = self.workdir / "checkpoint"
        pars = readconfig(str(self.cell.write_cfg(home, [seed], None, extra)))
        device = runner.resolve_device(pars)
        model = runner.build_model(pars)
        fwd = runner.make_torch_forward(model, device, gpriors=model.gpriors is not None)
        _, cfg, _ = runner._sampler_configs(pars, model, device)
        fingerprint = problem_fingerprint(model, cfg, seed, device)
        saved = []

        def on_chunk(state):
            if int(state.n_dead) < at:
                return
            if int(state.n_dead) == at:
                path = home / "state" / f"ns_state_{int(state.step):06d}.npz"
                save_state(str(path), state, fingerprint=fingerprint)
                saved.append(path)
            raise _Saved

        gen = torch.Generator(device=device).manual_seed(seed)
        try:
            nested_sample(fwd.loglike_cube, gen, cfg, device, on_chunk=on_chunk)
        except _Saved:
            pass
        if not saved:
            raise SetupFailed(f"the fit met no chunk boundary at resume_at {at} dead points")
        with np.load(saved[0]) as z:
            n = int(z["n_dead"])
            self.resume = Resume(seed, saved[0].parent, n, int(z["n_like"]),
                                 z["dead_u"][:n].copy(), z["dead_logl"][:n].copy())
        return self.resume

    def fit(self, k, seeds: List[int], max_samples: Optional[int] = None,
            extra: Optional[Dict[str, str]] = None) -> FitRecord:
        from mcalf_torch import cli
        from mcalf_torch.ops import voigt_cuda
        from mcalf_torch.sampler import graph
        from mcalf_torch.utils.profiling import get_timings

        rec = FitRecord(seeds)
        done_dead = done_like = 0
        if self.resume is not None:
            ckpt = self.workdir / f"fit{k}" / "checkpoint"
            shutil.copytree(self.resume.directory, ckpt)
            extra = dict(extra or {}, **{"run.checkpoint": str(ckpt)})
            done_dead, done_like = self.resume.n_dead, self.resume.n_like
        cfg = self.cell.write_cfg(self.workdir / f"fit{k}", seeds, max_samples, extra)
        self._captured.clear()
        self._rows.clear()
        spans = len(get_timings().get("nested_sampling", []))
        launches = voigt_cuda.launches + voigt_cuda.tau_launches
        g0 = dict(graph.stats)
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli.main([str(cfg)])
        except Exception:
            rec.error = traceback.format_exc()
        _sync()
        rec.wall_s = time.perf_counter() - t0
        rec.output = out.getvalue()[-4000:]
        rec.ns_s = float(sum(get_timings().get("nested_sampling", [])[spans:]))
        rec.calls = voigt_cuda.launches + voigt_cuda.tau_launches - launches
        rec.captures = graph.stats["captures"] - g0["captures"]
        rec.capture_s = graph.stats["capture_s"] - g0["capture_s"]
        rec.row_counts = Counter(self._rows)
        rec.base = self.cell.chain_base(cfg) if rec.error is None else None
        for kind, what in self._captured:
            if kind == "merge":
                rec.runs = list(what)
            elif kind == "solo" and not rec.runs:
                rec.runs = [what.numpy()]
        cap = self.cell.cap(cfg)
        for r in rec.runs:
            nlive = len(r.logl) - cap
            rec.dead += int(r.n_dead) - nlive - done_dead
            rec.n_like += int(r.n_like) - done_like
        return rec


#: the bench the spies report to (one per process at a time)
_ACTIVE: list = []


def _install_spies(bench: "Bench") -> None:
    """Route the fitter's merge and solo-fit results, and the rows of each
    likelihood call (counted as the card runs them), to ``bench``.  The
    wrappers are put in once per process and pass every call through."""
    from mcalf_torch import runner
    from mcalf_torch.models.torch_model import StackedForward, TorchForward
    from mcalf_torch.utils.profiling import count_launch

    _ACTIVE[:] = [bench]
    if getattr(runner.merge_results, "_benchmark_spy", False):
        return
    merge, solo = runner.merge_results, runner.nested_sample
    adders: dict = {}

    def merge_spy(runs, *a, **k):
        _ACTIVE[0]._captured.append(("merge", list(runs)))
        return merge(runs, *a, **k)

    def solo_spy(*a, **k):
        res = solo(*a, **k)
        _ACTIVE[0]._captured.append(("solo", res))
        return res

    def counting(fn, problems):
        def wrapped(fwd, u, *a, **k):
            key = (int(u.shape[0]), problems(fwd))
            if key not in adders:
                adders[key] = lambda n, key=key: _ACTIVE[0]._rows.update({key: n})
            if u.is_cuda:
                count_launch(adders[key])
            else:
                adders[key](1)
            return fn(fwd, u, *a, **k)
        return wrapped

    merge_spy._benchmark_spy = True
    runner.merge_results, runner.nested_sample = merge_spy, solo_spy
    StackedForward.loglike_cube = counting(StackedForward.loglike_cube, lambda f: f.nprob)
    TorchForward.loglike_cube = counting(TorchForward.loglike_cube, lambda f: 1)


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
