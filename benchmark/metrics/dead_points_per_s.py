"""Dead points the window's fits completed, summed over each fleet's seeds,
over the window's wall (host clock)."""


def read(rec):
    return rec["dead"] / rec["window_s"] if rec["dead"] else None
