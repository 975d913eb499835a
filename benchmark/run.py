"""Run one cell of the benchmark: ``python3 benchmark/run.py --workload NAME
--seed N --seconds S --trace 0|1``, from the root of a checkout, on a
machine with the CUDA cards the cell asks for.

Set-up (counted in ``setup_s``, from the start of this script): import the
fitter, build or load its kernel library (``build/mcalf_torch/`` inside the
checkout), and run one warm-up fit of the cell's own shapes capped at two
outer steps.  The window: fits of the cell back to back through
``mcalf_torch.cli.main``, each with fresh seeds drawn from ``--seed``; a
fit starts while ``--seconds`` are not yet spent, and the window ends when
the last one ends.  After it: with ``--trace 1`` one profiled fit (two outer steps)
and the per-layer metrics.  A cell whose traffic has ``resume_at`` first
makes, in set-up, the fitter's checkpoint at that many dead points from a
seed drawn from ``--seed`` (``harness.Bench.checkpoint``); then the warm-up,
every window fit and the profiled fit resume from a copy of it with that
seed and run to the cap, so every fit replays one continuation.  Then the
comparison against the plain reference
(:mod:`benchmark.check`), the outputs deleted, and one JSON line, the last
of standard output.  Without a CUDA card (or with fewer than the cell
asks for) it prints the reason on standard error and exits 2; it exits 3
if ``jax``, ``jaxlib``, ``flax`` or ``mcalf_tpu`` were loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: build and kernel caches at fixed paths inside the checkout
CACHES = {
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "mcalf_tpu")
#: outer steps of the warm-up fit
WARM_OUTER_STEPS = 2
#: seconds from the start of the script to points of the set-up
MARKS: dict = {}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_problem(chips: int):
    """Why this machine cannot run the cell, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is False (the benchmark measures the card only)"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, torch finds {torch.cuda.device_count()}"
    return None


def measure(args, device: str = "cuda", extra=None, seeds_per_fit=None, t0=None,
            with_control: bool = False, resume_at=None) -> dict:
    """Set-up, the window, the profiled fit (``args.trace``) and the check
    of one cell; returns the result line as a dict.  ``device='cpu'``,
    ``extra`` (``section.option``: value), ``seeds_per_fit`` and
    ``resume_at`` exist for the CPU tests of the harness (a run on the card
    takes none of them);
    ``with_control`` adds the control's numbers on the same fits
    (``benchmark/control.py``)."""
    import torch

    from benchmark import check, harness, spans, work
    from benchmark.reference.physics import Problem

    t0 = T0 if t0 is None else t0
    cell = harness.Cell(args.workload)
    if seeds_per_fit is not None:
        cell.seeds_per_fit = seeds_per_fit
    if resume_at is not None:
        cell.resume_at = resume_at
    extra = dict(extra or {})
    if device == "cpu":
        extra["run.device"] = "cpu"
    workdir = Path(tempfile.mkdtemp(prefix="mcalf_bench_"))
    try:
        from mcalf_torch import runner
        from mcalf_torch.config import readconfig

        t_imports = time.perf_counter() - t0
        bench = harness.Bench(cell, workdir)
        if device != "cpu":
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        Q = cell.seeds_per_fit
        probe = cell.write_cfg(workdir / "probe", [0] * Q, extra=extra)
        nd = runner.solver_nsconfig(readconfig(str(probe)), 1).cfg.resolved().num_delete
        cap = cell.cap(probe)
        resume, t_ckpt = None, time.perf_counter()
        try:
            if cell.resume_at:
                resume = bench.checkpoint(harness.fit_seeds(args.seed, "resume", 0, 1)[0], extra)
            t_ckpt = time.perf_counter() - t_ckpt

            def seeds(role, k):
                return [resume.seed] if resume is not None else harness.fit_seeds(args.seed, role, k, Q)

            # a resumed fit's state is sized for the cap its checkpoint was saved at
            edge_cap = None if resume is not None else WARM_OUTER_STEPS * nd
            warm = bench.fit("warm", seeds("warm-up", 0), edge_cap, extra)
            if warm.error:
                raise harness.SetupFailed(f"the warm-up fit failed:\n{warm.output}\n{warm.error}")
        except harness.SetupFailed as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return {"correct": False, "attempted": 0, "failed": 1, "metrics": {},
                    "device": _device_info(device, cell.chips),
                    "checks": {"failed_fits": {"value": 1.0, "limit": 0.0}}}
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        build = 0.0
        if device != "cpu":
            from mcalf_torch.ops import _build

            build = _build.load().build_seconds
        marks = "".join(f"{k} at {v:.3f} s, " for k, v in MARKS.items())
        ckpt = "" if resume is None else f"checkpoint at {resume.n_dead} dead points {t_ckpt:.3f} s, "
        print(f"setup: {setup_s:.3f} s; {marks}imports {t_imports:.3f} s, the card {t_card - t_imports:.3f} s, {ckpt}warm-up fit "
              f"{warm.wall_s:.3f} s (kernel build {build:.3f} s, sampling {warm.ns_s:.3f} s, "
              f"graph capture {warm.capture_s:.3f} s)", file=sys.stderr)

        fits = []
        span_marks = [spans.marks()]
        start = time.perf_counter()
        while not any(f.error for f in fits) and (
                not fits or time.perf_counter() - start < args.seconds):
            k = len(fits)
            fits.append(bench.fit(k, seeds("window", k), None, extra))
        window_s = time.perf_counter() - start
        span_marks.append(spans.marks())
        for k, f in enumerate(fits):
            print(f"fit {k}: wall {f.wall_s:.3f} s, sampling {f.ns_s:.3f} s, dead points {f.dead}, "
                  f"evaluations {f.n_like}, likelihood calls {f.calls}, graph captures {f.captures} "
                  f"({f.capture_s:.3f} s)", file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

        problem = Problem(str(probe), str(cell.datadir))
        rec = {
            "setup_s": setup_s, "window_s": window_s, "fits": len(fits), "span_marks": span_marks,
            "dead": sum(f.dead for f in fits), "n_like": sum(f.n_like for f in fits),
            "calls": sum(f.calls for f in fits), "ns_s": sum(f.ns_s for f in fits),
            "host_s": sum(f.wall_s - f.ns_s for f in fits),
            "capture_s": sum(f.capture_s for f in fits),
        }
        out = {"correct": False, "attempted": len(fits),
               "failed": sum(1 for f in fits if f.error)}
        device_info = _device_info(device, cell.chips, peak)
        breakdown = None
        if args.trace:
            from benchmark import trace

            if device != "cpu":
                print("card: " + _smi(), file=sys.stderr)
            prof, prec = trace.profiled_fit(bench, "profiled", seeds("profiled", 0),
                                            edge_cap, workdir, extra)
            rec["profile"] = dict(prof, calls=prec.calls,
                                  row_counts=dict(prec.row_counts))
            rec["ops_per_eval"] = work.ops_per_eval(problem, args.seed & (2**32 - 1))
            rec["launch_bytes"] = {f"{r},{q}": work.launch_bytes(problem, r, q)
                                   for r, q in prec.row_counts}
            device_info["busy_s"] = prof["busy_us"] * 1e-6
            device_info["window_s"] = (prof["window_us"] or prof["wall_s"] * 1e6) * 1e-6
            breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        metrics = {}
        for m in (cell.per_layer if args.trace else cell.end_to_end):
            value = harness.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

        for f in fits:
            if f.error:
                print(f"fit failed:\n{f.output}\n{f.error}", file=sys.stderr)
        judged = [check.Fit(f.seeds, f.runs, f.base, cap, nd, resume) for f in fits]
        numbers = check.compare(problem, judged, args.seed)
        if with_control:
            out["control"] = check.control_numbers(problem, judged, args.seed)
        out["correct"] = bool(check.verdict(numbers, cell.limits)) and out["failed"] == 0
        out["metrics"] = metrics
        out["device"] = device_info
        if breakdown is not None:
            out["breakdown"] = breakdown
        limits = {k: cell.limits.get(k, 0) for k in numbers}
        out["checks"] = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in numbers}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _device_info(device: str, chips: int, peak: int = 0) -> dict:
    import torch

    return {"platform": "gpu" if device != "cpu" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}


def _smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    import json

    args = parse(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(args.workload)
    import torch  # noqa: F401

    MARKS["torch imported"] = time.perf_counter() - T0
    why = card_problem(cell.chips)
    MARKS["card found"] = time.perf_counter() - T0
    if why:
        print(f"benchmark: {why}", file=sys.stderr)
        return 2
    out = measure(args)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
