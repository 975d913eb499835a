"""Seconds from the start of the run to the start of the window: imports,
the kernel library's build or load, and the warm-up fit (host clock)."""


def read(rec):
    return rec["setup_s"]
