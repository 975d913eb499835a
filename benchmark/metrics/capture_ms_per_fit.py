"""Host milliseconds per fit spent warming up and capturing the slice
loop's CUDA graphs (``sampler.graph.stats['capture_s']``)."""


def read(rec):
    return 1e3 * rec["capture_s"] / rec["fits"] if rec["capture_s"] and rec["fits"] else None
