"""Share of the unprofiled window in which the device is idle: 1 less the
profiled fit's device-busy microseconds per likelihood call (the union of
kernel, copy and set intervals) times the calls the window ran, over the
window's wall.  Host time between fits counts as idle."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["calls"] or not p["busy_us"] or not rec["calls"]:
        return None
    busy = p["busy_us"] * 1e-6 / p["calls"] * rec["calls"]
    return 100.0 * (1.0 - busy / rec["window_s"])
