"""The share of the fused kernel's line evaluations that took the full
Voigt-Hjerting function (Algorithm 916 / asymptotic), in percent: the
fitter's ``hjert_lines`` over its ``lines`` (rows x transitions of every
fused launch, counted as the card runs them), read from
``mcalf_torch.ops.voigt_cuda`` over the run's process.  None on a fitter
without the counters, or before any fused launch."""


def read(rec):
    from mcalf_torch.ops import voigt_cuda

    lines = getattr(voigt_cuda, "lines", 0)
    hjert = getattr(voigt_cuda, "hjert_lines", None)
    if hjert is None or not lines:
        return None
    return 100.0 * hjert / lines
