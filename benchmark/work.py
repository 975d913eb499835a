"""Operations and bytes of one likelihood evaluation, from shapes and physics.

The count belongs to the benchmark, not to any kernel: it never reads an
implementation's wing window, mode table or operation census, so it stays
the same whatever implements the likelihood.  Each (row, transition,
pixel) of an active line is counted by the regime its damping a and its
distance u from line centre put it in:

* a < HARRIS_A_MAX: the Harris expansion, by the Dawson region of u^2;
* otherwise Algorithm 916 where u^2 + a^2 < R2_SWITCH, the asymptotic form
  outside, plus the per-(row, transition) set-up of a damped line.

A fused multiply-add counts 2, every other arithmetic operation, division
or transcendental 1, compares and selects 0; each pixel's count includes
forming u (3) and adding into tau (2).  Per row the likelihood adds the
exponential, the line-spread function over the pixels it convolves and
the chi^2 (4 a pixel), and what a configuration's nuisance keys add
(:func:`nuisance_row_ops`).  Each input byte is read once and each output
byte written once.
"""

from __future__ import annotations

import numpy as np

#: damping below which the Harris expansion is accurate to float32
HARRIS_A_MAX = 1e-3
#: u^2 + a^2 below which Algorithm 916's series is used
R2_SWITCH = 111.0
#: operations per pixel of the Harris expansion, by Dawson region of u^2
#: (bounds 2.25, 6.25, 16, inf)
OPS_HARRIS = (39, 40, 35, 30)
HARRIS_EDGES = (2.25, 6.25, 16.0)
OPS_916 = 246
OPS_ASYM = 43
#: per (row, transition) of a damped line: 27 series denominators, sigma1, erfcx
OPS_DAMPED_LINE = 180
#: per (row, transition) of any line: 1 / dnu
OPS_LINE = 1

#: the H100 SXM's published peaks at 700 W: float32 outside the tensor
#: cores, and device memory bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def tau_ops(x2: np.ndarray, a: np.ndarray, active: np.ndarray) -> float:
    """Operations of the optical depth: ``x2`` (rows, T, P) squared distance
    from line centre in Doppler widths, ``a`` (rows, T) damping,
    ``active`` (rows, T) whether the line is in the model."""
    x2 = np.asarray(x2, np.float64)
    a = np.asarray(a, np.float64)
    active = np.asarray(active, bool)
    harris = (a < HARRIS_A_MAX) & active
    damped = (~(a < HARRIS_A_MAX)) & active
    ops = OPS_LINE * float(active.sum()) + OPS_DAMPED_LINE * float(damped.sum())
    region = np.searchsorted(np.asarray(HARRIS_EDGES), x2, side="left")
    per = np.asarray(OPS_HARRIS, np.float64)[region]
    ops += float((per * harris[..., None]).sum())
    near = (x2 + a[..., None] ** 2) < R2_SWITCH
    ops += float((np.where(near, OPS_916, OPS_ASYM) * damped[..., None]).sum())
    return ops


def row_ops(npix: int, half: int) -> float:
    """Operations per row after the optical depth: exp, the line-spread
    function over the pixels it convolves (a multiply-add per tap), chi^2."""
    taps = 2 * half + 1
    return float(npix + 2 * taps * max(npix - 2 * half, 0) * (half > 0) + 4 * npix)


def nuisance_row_ops(problem) -> float:
    """Operations per row that the nuisance keys add, 0 without them: a free
    resolution makes the row's K = 2 half + 1 taps (an exponential, an add
    into their sum and a divide by it each); a free continuum scales each
    pixel of the row's model (a fixed one folds into the data); asymmlike
    counts the valid pixels whose residual passes 4 and 5 noise widths (two
    compares against per-pixel thresholds, and two adds)."""
    ops = 0.0
    if problem.free_res:
        ops += 3.0 * (2 * problem.half + 1)
    if problem.free_cont:
        ops += float(problem.npix)
    if problem.asymm:
        ops += 2.0 * float(np.sum(problem.valid))
    return ops


def eval_ops(problem, u: np.ndarray, block: int = 16) -> float:
    """Operations of the likelihood over the unit-cube rows ``u`` of
    ``problem`` (a :class:`benchmark.reference.physics.Problem`), taken in
    blocks of ``block`` rows."""
    u = np.atleast_2d(np.asarray(u, np.float32))
    ops = u.shape[0] * (row_ops(problem.npix, problem.half) + nuisance_row_ops(problem))
    for s in range(0, u.shape[0], block):
        z, _, a, dnu, active = problem.line_tables(u[s:s + block])
        x = problem.u_voigt(z, dnu)
        ops += tau_ops(x * x, a, active)
    return ops


def ops_per_eval(problem, seed: int, rows: int = 128) -> float:
    """Mean operations per evaluation over ``rows`` prior draws made from
    ``seed``."""
    u = np.random.default_rng(seed).random((rows, problem.ndim)).astype(np.float32)
    return eval_ops(problem, u) / rows


def launch_bytes(problem, rows: int, problems: int) -> int:
    """Bytes one likelihood launch must move: per row its (dz, amplitude,
    a, dnu) per transition, LSF taps (a free resolution's row: its FWHM,
    from which the card makes them), continuum, problem index and three
    outputs; per problem the (transition, pixel) offsets, the pixels' c /
    lambda, data, inverse variance and inverse noise; per transition two
    table entries."""
    T, P = problem.ntrans, problem.npix
    K = 1 if problem.free_res else 2 * problem.half + 1
    per_row = 4 * T + K + 1 + (1 if problems > 1 else 0) + 3
    per_problem = T * P + 4 * P
    return 4 * (rows * per_row + problems * per_problem + 2 * T)


def least_seconds(ops: float, nbytes: float):
    """(seconds, bound): the least time the chip could take, and whether
    operations or bytes set it."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


__all__ = [
    "tau_ops", "row_ops", "nuisance_row_ops", "eval_ops", "ops_per_eval", "launch_bytes",
    "least_seconds", "PEAK_F32", "PEAK_BYTES", "HARRIS_A_MAX",
]
