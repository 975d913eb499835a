"""Host milliseconds per fit writing chain files: the fitter's
``runner.files`` span (each ``.stats`` and ``_equal_weights.txt`` pair,
every seed's and the merged one; benchmark/spans.py), over the window."""

from benchmark import spans


def read(rec):
    got = spans.window(rec, "runner.files")
    return 1e3 * sum(got) / rec["fits"] if got else None
