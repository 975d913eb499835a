"""Milliseconds of the ``nested_sampling`` span per likelihood call run
(the kernels' launch counters over the window)."""


def read(rec):
    return 1e3 * rec["ns_s"] / rec["calls"] if rec["calls"] else None
