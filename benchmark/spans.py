"""The fitter's phase spans of a run's window, from its span registry.

The fitter records every phase span (``mcalf_torch.utils.profiling.
phase_timer``) in a registry of its process: name -> durations, in the
order the phases ended.  A run of ``benchmark/run.py`` is one process: its
set-up records spans before the window, and with ``--trace 1`` the profiled
fit records more after it.  The run takes :func:`marks` of the registry as
the window opens and as it closes (``rec["span_marks"]``), and the run's
record holds the window's ``nested_sampling`` sum (``ns_s``); a metric of
another span takes the window's entries between the two marks.

:func:`window` does so only where the registry is this run's: one
``nested_sampling`` entry per window fit between the marks, summing to
``ns_s``.  Elsewhere, and on a fitter without the span, it finds nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def _registry() -> dict:
    from mcalf_torch.utils.profiling import get_timings

    return get_timings()


def marks() -> Dict[str, int]:
    """How many entries each span of the registry holds now."""
    return {name: len(got) for name, got in _registry().items()}


def _between(rec, spans: dict, name: str) -> Optional[List[float]]:
    opened, closed = rec.get("span_marks") or ({}, {})
    lo, hi = opened.get(name, 0), closed.get(name, 0)
    got = spans.get(name, [])
    return got[lo:hi] if lo <= hi <= len(got) else None


def is_this_run(rec, spans: Optional[dict] = None) -> bool:
    spans = _registry() if spans is None else spans
    ns = _between(rec, spans, "nested_sampling")
    if not rec.get("fits") or ns is None or len(ns) != rec["fits"]:
        return False
    return math.isclose(sum(ns), rec["ns_s"], rel_tol=1e-9, abs_tol=1e-12)


def window(rec, name: str) -> Optional[List[float]]:
    """The entries of span ``name`` that the window's fits recorded."""
    spans = _registry()
    if name not in spans or not is_this_run(rec, spans):
        return None
    return _between(rec, spans, name)
