"""Host milliseconds per fit outside the sampler: each fit's wall less its
``nested_sampling`` phase span (config, model, forward, merge, files)."""


def read(rec):
    return 1e3 * rec["host_s"] / rec["fits"] if rec["fits"] else None
