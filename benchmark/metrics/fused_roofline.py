"""The fused likelihood kernel's share of its roofline in the profiled fit:
the least time the card could take for the launches' work (operations
from benchmark/work.py, per evaluation, times the rows each launch
evaluated; bytes per launch), over the kernel's device time in the trace."""

from benchmark import work


def read(rec):
    p = rec.get("profile")
    if not p or not p["fused_us"] or not p["row_counts"]:
        return None
    ops = sum(r * n for (r, _), n in _pairs(p)) * rec["ops_per_eval"]
    nbytes = sum(rec["launch_bytes"][f"{r},{q}"] * n for (r, q), n in _pairs(p))
    least, _ = work.least_seconds(ops, nbytes)
    return 100.0 * least / (p["fused_us"] * 1e-6)


def _pairs(p):
    return [(tuple(k) if not isinstance(k, str) else tuple(map(int, k.split(","))), n)
            for k, n in p["row_counts"].items()]
