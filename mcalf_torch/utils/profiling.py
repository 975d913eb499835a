"""Profiling and tracing hooks; port of :mod:`mcalf_tpu.utils.profiling`.

* :func:`phase_timer` -- context manager recording named phase durations in a
  process-global registry (queryable via :func:`get_timings`).  While the
  torch profiler records, the phase is also a ``record_function`` span, so
  it appears in a Chrome trace as a ``user_annotation`` on the clock of the
  device's kernels.
* :func:`enable_counters` -- the switch of the slice loop's device-side
  counter of the rows whose chain had a pass to make
  (``sampler.graph.stats['rows_active']``); off by default, when the loop
  issues no op for it.
* :func:`trace` -- context manager wrapping ``torch.profiler`` when a trace
  directory is configured (MCALF_TORCH_TRACE_DIR env var or argument),
  writing a Chrome trace (``*.pt.trace.json``, which TensorBoard's and
  Perfetto's viewers read) of host and, where there is a card, device
  activity; no-op otherwise.  It yields the profiler (None when off), so a
  caller can read ``key_averages()`` as well.
* :func:`count_launch` / :func:`captured_launches` -- kernel launch counts
  that hold under CUDA graphs: a launch counts when the card runs it, so a
  launch made while a graph is captured counts once per replay of that
  graph.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

_TIMINGS: Dict[str, List[float]] = defaultdict(list)
#: whether the slice loop counts its active rows on the device
_counting = False


class Span:
    """What :func:`phase_timer` yields: ``seconds`` holds the phase's
    duration, as the registry records it, once the block has ended."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


@contextlib.contextmanager
def phase_timer(name: str):
    import torch

    span = Span()
    annotate = (torch.profiler.record_function(name) if torch.autograd._profiler_enabled()
                else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with annotate:
            yield span
    finally:
        span.seconds = time.perf_counter() - t0
        _TIMINGS[name].append(span.seconds)


def get_timings() -> Dict[str, List[float]]:
    return {k: list(v) for k, v in _TIMINGS.items()}


def reset_timings() -> None:
    _TIMINGS.clear()


def enable_counters(on: bool = True) -> bool:
    """Switch the slice loop's active-row counter on or off for the loops
    that start from now on; returns the previous setting.  A run's captured
    graph is captured again when the setting changes."""
    global _counting
    was, _counting = _counting, bool(on)
    return was


def counters_enabled() -> bool:
    return _counting


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """Wrap a block in a torch.profiler trace if a directory is given (or the
    MCALF_TORCH_TRACE_DIR environment variable is set): CPU activity, and
    CUDA activity when torch finds a card.  The trace is written to
    ``<dir>/<host>_<pid>_<ns>.pt.trace.json`` when the block ends."""
    trace_dir = trace_dir or os.environ.get("MCALF_TORCH_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}_{os.getpid()}_{time.time_ns()}.pt.trace.json"
    ))


#: serialises every count: blocks of a fleet on several local devices run
#: from their own host threads (parallel/fleet.py)
_count_lock = threading.Lock()
#: per thread, the launches counted while a CUDA graph is being captured
#: inside :func:`captured_launches` (``.tally``: the counter's ``add`` ->
#: launches); a capture belongs to the thread that makes it
_capture = threading.local()


def count_launch(add: Callable[[int], None]) -> None:
    """Count one kernel launch on a CUDA stream by calling ``add(1)``.  A
    launch made while the current stream is captured into a CUDA graph runs
    only when the graph is replayed: inside :func:`captured_launches` it is
    tallied and counted at each replay; a capture outside it (a timing
    graph) counts nothing."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        with _count_lock:
            add(1)
        return
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[add] = tally.get(add, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """Tally the launches :func:`count_launch` sees while a graph is
    captured in the block.  Yields the function to call after each replay of
    that graph: it counts the tallied launches once more."""
    outer, tally = getattr(_capture, "tally", None), {}
    _capture.tally = tally

    def replayed() -> None:
        with _count_lock:
            for add, n in tally.items():
                add(n)

    try:
        yield replayed
    finally:
        _capture.tally = outer
