"""The profiled fit of a ``--trace 1`` run, and what its trace says.

One short fit of the cell's own shapes runs under ``torch.profiler`` after
the measured window, with the fitter's runner- and sampler-level functions
wrapped in ``record_function`` spans of their own name.  The Chrome trace
is written under TMPDIR, read and deleted.  From it:

* the device's busy time: the union of its kernel, copy and set
  intervals inside the fit's span;
* device time by kernel name, and the fused likelihood and optical-depth
  kernels' apart;
* the idle gaps between busy intervals, each named by the innermost
  wrapped span and the innermost host operation that cover its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

FUSED, TAU = "fused_loglike_kernel", "voigt_tau_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: (module, function) pairs wrapped in spans of their own name
SPANS = (
    ("mcalf_torch.runner", "run_fit"),
    ("mcalf_torch.runner", "build_model"),
    ("mcalf_torch.runner", "make_torch_forward"),
    ("mcalf_torch.runner", "_sampler_configs"),
    ("mcalf_torch.runner", "stack_problems"),
    ("mcalf_torch.runner", "fit_stacked"),
    ("mcalf_torch.runner", "unstack_results"),
    ("mcalf_torch.runner", "merge_results"),
    ("mcalf_torch.runner", "insertion_rank_test"),
    ("mcalf_torch.runner", "_write_chain_files"),
    ("mcalf_torch.sampler.nested", "_initial_states"),
    ("mcalf_torch.sampler.nested", "_head"),
    ("mcalf_torch.sampler.nested", "_slice_stacked"),
    ("mcalf_torch.sampler.nested", "_tail"),
    ("mcalf_torch.sampler.nested", "_recluster"),
    ("mcalf_torch.sampler.nested", "finalize"),
)
FIT_SPAN = "benchmark.fit"


@contextlib.contextmanager
def spans():
    """Wrap :data:`SPANS` in ``record_function`` spans, and put them back."""
    import importlib

    from torch.profiler import record_function

    saved = []
    for modname, attr in SPANS:
        mod = importlib.import_module(modname)
        if not hasattr(mod, attr):
            continue
        fn = getattr(mod, attr)
        label = f"{modname.rsplit('.', 1)[-1]}.{attr}"

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _kernel_name(name: str) -> str:
    """A kernel's name without its argument list and common prefixes."""
    for junk in ("void ", "(anonymous namespace)::", "at::native::", "at::"):
        name = name.replace(junk, "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def _innermost(events, t):
    """Name of the shortest event of ``events`` (ts, end, name) covering t."""
    best, name = np.inf, "none"
    for a, b, n in events:
        if a <= t <= b and b - a < best:
            best, name = b - a, n
    return name


def profiled_fit(bench, k, seeds, max_samples, tmpdir: Path, extra=None):
    """Run one fit under the profiler; the trace's readings and the fit's
    record."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    path = Path(tmpdir) / "profile.pt.trace.json"
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with spans(), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(FIT_SPAN):
            rec = bench.fit(k, seeds, max_samples, extra)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        os.unlink(path)
    out = read_trace(events)
    out["wall_s"] = wall
    print(f"profile: fit {wall:.3f} s under the profiler, {len(events)} trace events "
          f"read in {time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return out, rec


def read_trace(events) -> dict:
    """Busy time, device time by kernel and the longest idle gaps of the
    ``FIT_SPAN`` window of a Chrome trace's events (microseconds)."""
    fit = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == FIT_SPAN]
    lo, hi = (fit[0]["ts"], fit[0]["ts"] + fit[0]["dur"]) if fit else (-np.inf, np.inf)
    dev = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
           if e.get("cat") in DEVICE_CATS and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = _union(dev)
    busy_us = float(sum(b - a for a, b in busy))
    kernels = Counter()
    fused_us = tau_us = 0.0
    fused_runs = 0
    for e in events:
        if e.get("cat") == "kernel" and lo <= e["ts"] <= hi:
            kernels[_kernel_name(e["name"])] += e["dur"]
            if FUSED in e["name"]:
                fused_us += e["dur"]
                fused_runs += 1
            elif TAU in e["name"]:
                tau_us += e["dur"]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if np.isfinite(edges[i]) and np.isfinite(edges[i + 1]) and edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    ann = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "user_annotation" and e.get("name") != FIT_SPAN]
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") in ("cpu_op", "cuda_runtime")]
    idle = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        idle.append([f"{_innermost(ann, mid)} | {_innermost(ops, mid)}", (b - a) * 1e-6])
    return {
        "busy_us": busy_us,
        "window_us": float(hi - lo) if fit else None,
        "kernel_us": float(sum(kernels.values())),
        "fused_us": float(fused_us),
        "fused_runs": fused_runs,
        "tau_us": float(tau_us),
        "device_ops": [[n, v * 1e-6] for n, v in kernels.most_common(10)],
        "idle_gaps": idle,
    }
