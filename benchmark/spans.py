"""The fitter's phase spans of a run's window, from its span registry.

The fitter records every phase span (``mcalf_torch.utils.profiling.
phase_timer``) in a registry of its process: name -> durations, in the
order the phases ended.  A run of ``benchmark/run.py`` is one process whose
fits end in this order: the warm-up fit, the window's fits, and with
``--trace 1`` the profiled fit.  The run's record holds, of these spans,
the window's ``nested_sampling`` sum alone (``ns_s``), so a metric of
another span takes the window's entries from that order.

:func:`window` does so where each fit records a span the same number of
times or, as the slice loop's spans, where the warm-up and the profiled
fit record it a known number of times; and only where the registry is this
run's: one ``nested_sampling`` entry per fit, the window's summing to
``ns_s``.  Elsewhere, and on a fitter without the span, it finds nothing.
"""

from __future__ import annotations

import math
from typing import List, Optional


def _registry() -> dict:
    from mcalf_torch.utils.profiling import get_timings

    return get_timings()


def _edges(rec) -> tuple:
    """Fits of the run before and after its window."""
    return 1, 1 if "profile" in rec else 0


def is_this_run(rec, spans: Optional[dict] = None) -> bool:
    spans = _registry() if spans is None else spans
    ns = spans.get("nested_sampling", [])
    before, after = _edges(rec)
    if not rec.get("fits") or len(ns) != before + rec["fits"] + after:
        return False
    got = sum(ns[before:len(ns) - after])
    return math.isclose(got, rec["ns_s"], rel_tol=1e-9, abs_tol=1e-12)


def window(rec, name: str, per_edge_fit: Optional[int] = None) -> Optional[List[float]]:
    """The entries of span ``name`` that the window's fits recorded.
    ``per_edge_fit``: how many the warm-up fit, and the profiled fit, each
    recorded; None where every fit of the run records it equally often."""
    spans = _registry()
    if name not in spans or not is_this_run(rec, spans):
        return None
    got = spans[name]
    before, after = _edges(rec)
    if per_edge_fit is None:
        fits = before + rec["fits"] + after
        if len(got) % fits:
            return None
        per_edge_fit = len(got) // fits
    lo, hi = before * per_edge_fit, len(got) - after * per_edge_fit
    return got[lo:hi] if hi >= lo else None
