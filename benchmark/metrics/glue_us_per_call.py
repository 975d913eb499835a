"""Device microseconds per likelihood call of every kernel of the profiled
fit but the fused likelihood and the optical-depth kernels."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["calls"] or not p["kernel_us"]:
        return None
    return (p["kernel_us"] - p["fused_us"] - p["tau_us"]) / p["calls"]
