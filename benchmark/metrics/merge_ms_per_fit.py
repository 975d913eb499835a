"""Host milliseconds per fit in the merge of the fleet's seeds: the
fitter's ``runner.merge`` span (benchmark/spans.py), over the window."""

from benchmark import spans


def read(rec):
    got = spans.window(rec, "runner.merge")
    return 1e3 * sum(got) / rec["fits"] if got else None
