"""Host milliseconds per fit of the sampler outside the slice loop and the
graph capture: the window's ``nested_sampling`` span less its
``sampler.slice_loop`` spans (benchmark/spans.py) and its capture seconds
(``sampler.graph.stats['capture_s']``, the ``sampler.capture`` span's own
measurement).  What is left: the live sets' start, each outer step's heads
and tails, the termination reads and chunk boundaries, ``finalize`` and the
results' copies to the host."""

from benchmark import spans


def read(rec):
    got = spans.window(rec, "sampler.slice_loop")
    if not got:
        return None
    host = rec["ns_s"] - sum(got) - rec["capture_s"]
    return 1e3 * host / rec["fits"] if host > 0 else None
