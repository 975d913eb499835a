"""Likelihood calls per dead point over the window: the kernels' launch
counters (one launch a call, counted as the card runs it) over the dead
points the window's fits added, summed over each fleet's seeds."""


def read(rec):
    return rec["calls"] / rec["dead"] if rec["calls"] and rec["dead"] else None
