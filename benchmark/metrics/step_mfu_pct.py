"""The whole sampling step's share of the card's float32 peak: the
operations of the evaluations the window's fits made (benchmark/work.py's
count per evaluation times the sampler's n_like) over the
``nested_sampling`` span's wall."""

from benchmark import work


def read(rec):
    if "ops_per_eval" not in rec or not rec["ns_s"] or not rec["n_like"]:
        return None
    return 100.0 * rec["ops_per_eval"] * rec["n_like"] / (rec["ns_s"] * work.PEAK_F32)
