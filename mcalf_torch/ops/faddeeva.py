"""Voigt--Hjerting functions on torch tensors (float32).

Port of :mod:`mcalf_tpu.ops.faddeeva`:

* the small-damping (Harris) half: the piecewise Dawson integral, the
  3-term Harris expansion and its far-wing tail;
* the strong-damping half: ``erfcx`` (Shepherd & Laframboise 1981),
  ``wofz_real_916`` (Algorithm 916, Zaghloul & Ali 2011, h = 1/2, 27 terms,
  the Gaussian terms by the three-anchor multiplicative recurrence),
  ``wofz_real_asym`` (the large-|z| asymptotic form) and ``hjert``, which
  switches between the last two at u^2 + a^2 = 111.

Every function is elementwise with broadcasting (``a`` may be a
per-(sample, transition) column against a pixel axis), computes in
float32 and selects regions with ``torch.where``, exactly as the JAX
versions do, so the two agree to float32 rounding.

The coefficient tables below are the single source of truth for the CUDA
kernels as well: :mod:`mcalf_torch.ops._build` writes them into the
kernels' generated header.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "erfcx",
    "wofz_real_916",
    "wofz_real_asym",
    "hjert",
    "dawsn",
    "hjert_harris",
    "hjert_wing",
    "hjert_harris_win",
    "HARRIS_A_MAX",
    "HJERT_WIN_TMIN",
    "DAWSN_P1",
    "DAWSN_P2",
    "DAWSN_P3",
    "DAWSN_P4",
    "ERFCX_COEF",
    "N_TERMS",
    "AN",
    "AN2",
    "EXP_AN2",
    "UP_RATIO",
    "E_QUARTER",
    "R2_SWITCH",
]

# Chebyshev coefficients for (1 + 2a) erfcx(a) in q = (a - 2)/(a + 2)
# (Shepherd & Laframboise 1981), highest order first, float32 values.
ERFCX_COEF = tuple(float(v) for v in np.array(
    [5.92470169e-5, 1.61224554e-4, -3.46481771e-4, -1.39681227e-3,
     1.20588380e-3, 8.69014394e-3, -8.01387429e-3, -5.42122945e-2,
     1.64048523e-1, -1.66031078e-1, -9.27637145e-2, 2.76978403e-1],
    dtype=np.float32,
))

# Algorithm 916 series grid a_n = n/2, n = 1..N_TERMS (float32 values).
N_TERMS = 27
_AN = (0.5 * np.arange(1, N_TERMS + 1)).astype(np.float32)
AN = tuple(float(v) for v in _AN)
AN2 = tuple(float(v) for v in (_AN * _AN).astype(np.float32))
EXP_AN2 = tuple(
    float(v) for v in np.exp(-(_AN * _AN).astype(np.float32).astype(np.float64))
    .astype(np.float32)
)
#: exp(-(a_{n+1} -+ x)^2) = exp(-(a_n -+ x)^2) exp(+-x) UP_RATIO[n]
UP_RATIO = tuple(float(np.exp(-(2 * n + 3) / 4.0)) for n in range(N_TERMS))
E_QUARTER = float(np.exp(-0.25))
#: the three anchors of the Gaussian-term recurrence (0-based n) and the
#: nearest-anchor cuts on |x| between them
N_MID = N_TERMS // 2
LO_CUT = 0.5 * (AN[0] + AN[N_MID])
HI_CUT = 0.5 * (AN[N_MID] + AN[N_TERMS - 1])
#: hjert takes the 916 series for x^2 + a^2 below this, the asymptotic form
#: above it (the reference's switch radius)
R2_SWITCH = 111.0

# Piecewise-polynomial f32 Dawson integral F(x) = e^{-x^2} int_0^x e^{t^2} dt
# (tools/fit_dawson.py), lowest order first:
#   R1: t = x^2 in [0, 2.25]      F = x * P1(t)
#   R2: t in (2.25, 6.25]         F = x * P2(t - 4.25)
#   R3: v = 1/t in [1/16, 0.16]   F = x*v/2 * (1 + v * P3(v - 0.111))
#   R4: v in (0, 1/16]            F = x*v/2 * (1 + v * P4(v))
DAWSN_P1 = (1.0, -0.6666666865348816, 0.2666666507720947, -0.07619033753871918,
            0.016930753365159035, -0.003077461151406169, 0.00047237955732271075,
            -6.21086364844814e-05, 6.846393716841703e-06, -5.695005711459089e-07,
            2.609287363952717e-08)
DAWSN_P2 = (0.1402396857738495, -0.03909141942858696, 0.009945407509803772,
            -0.0021992167457938194, 0.00041756173595786095, -6.845255120424554e-05,
            9.795944606594276e-06, -1.233995476468408e-06, 1.3953918198694737e-07,
            -1.5512020112851133e-08, 1.4320578056725708e-09)
DAWSN_P3 = (0.6264359951019287, 1.7964502573013306, 6.447943687438965,
            -53.4018440246582, -640.7386474609375, 4220.55224609375,
            32805.28515625, -363086.125, -33727.375)
DAWSN_P4 = (0.5000000596046448, 0.7499195337295532, 1.8925540447235107,
            5.018493175506592, 94.2889404296875, -1155.8101806640625,
            12073.4189453125)

#: damping bound below which the Harris expansion is accurate (<= ~1e-6
#: relative vs scipy wofz); see mcalf_tpu.ops.faddeeva.HARRIS_A_MAX
HARRIS_A_MAX = 1e-3

#: floor on the per-transition wing threshold tmin of hjert_harris_win
HJERT_WIN_TMIN = 21.0

TWO_OVER_SQRTPI = 2.0 / math.sqrt(math.pi)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, float(coeffs[-1]))
    for c in coeffs[-2::-1]:
        p.mul_(x).add_(float(c))
    return p


def _dawsn_h1core(x):
    """(F(x), 2 x F(x) - 1), the second computed without cancellation (in
    the tail regions 2xF - 1 = v * g(v) with v = 1/x^2)."""
    x = _f32(x)
    t = x * x
    p_head = torch.where(
        t <= 2.25, _horner(DAWSN_P1, t), _horner(DAWSN_P2, t - 4.25)
    )
    v = 1.0 / torch.clamp(t, min=1.0)  # tail only selected for t > 6.25
    g = torch.where(
        t <= 16.0, _horner(DAWSN_P3, v - 0.111), _horner(DAWSN_P4, v)
    )
    near = t <= 6.25
    F = torch.where(near, x * p_head, 0.5 * x * v * (1.0 + v * g))
    h1core = torch.where(near, 2.0 * t * p_head - 1.0, v * g)
    return F, h1core


def dawsn(x):
    """Dawson integral F(x), float32, elementwise (<= 5.3e-7 relative)."""
    return _dawsn_h1core(x)[0]


def hjert_harris(x, a):
    """H(x, a) by the 3-term Harris expansion
    e^{-x^2}(1 + a^2(1 - 2x^2)) + a (2/sqrt(pi)) (2xF(x) - 1)."""
    x = _f32(x)
    a = _f32(a)
    t = x * x
    E = torch.exp(-t)
    _, h1core = _dawsn_h1core(x)
    return E * (1.0 + a * a * (1.0 - 2.0 * t)) + a * (TWO_OVER_SQRTPI * h1core)


def hjert_wing(x, a):
    """Far-wing H: :func:`hjert_harris` without its e^{-x^2} terms (exact
    to e^{-tmin}(1 + 2a^2 tmin) for x^2 >= tmin >= HJERT_WIN_TMIN)."""
    x = _f32(x)
    a = _f32(a)
    t = x * x
    v = 1.0 / torch.clamp(t, min=16.0)
    return a * ((TWO_OVER_SQRTPI * v) * _horner(DAWSN_P4, v))


def hjert_harris_win(x, a, tmin=HJERT_WIN_TMIN):
    """``hjert_harris`` for x^2 < tmin, ``hjert_wing`` outside."""
    x = _f32(x)
    return torch.where(x * x < tmin, hjert_harris(x, a), hjert_wing(x, a))


# ---------------------------------------------------------------------------
# Strong damping: erfcx, Algorithm 916, the asymptotic form, hjert.
# ---------------------------------------------------------------------------

def erfcx(x):
    """Scaled complementary error function exp(x^2) erfc(x), float32
    (rational Chebyshev form, accurate to float32 for x > -9.3)."""
    x = _f32(x)
    a = torch.abs(x)
    b = (a - 2.0) / (a + 2.0)
    q = (-a * b - 2.0 * (b + 1.0) + a) / (a + 2.0) + b
    p = torch.full_like(q, ERFCX_COEF[0])
    for coef in ERFCX_COEF[1:]:
        p = p * q + coef
    # undo the (1 + 2a) scaling with a compensated division
    quot = (p + 1.0) / (1.0 + 2.0 * a)
    resid = (p + 1.0) - quot * (1.0 + 2.0 * a)
    f = 0.5 * resid / (a + 0.5) + quot
    return torch.where(x >= 0.0, f, 2.0 * torch.exp(x * x) - f)


def wofz_real_916(x, y):
    """Re[w(x + iy)] by Algorithm 916 with h = 1/2 and N_TERMS terms,
    float32-accurate for x^2 + y^2 < R2_SWITCH.

    ``y`` may have a smaller (broadcastable) shape than ``x``: erfcx(y),
    sigma1 and the series denominators 1/(a_n^2 + y^2) are computed at y's
    shape.  The Gaussian terms exp(-(a_n -+ x)^2) come from a multiplicative
    recurrence in exp(+-x); the minus terms start from the nearest of three
    anchors (n = 1, N_MID + 1, N_TERMS), all three computed and one
    selected per element, as in the JAX version."""
    xs = _f32(x)
    y = _f32(y)
    x = torch.abs(xs)
    xy = x * y
    exx = torch.exp(-x * x)
    ex = torch.exp(x)
    iex = 1.0 / ex
    y2 = y * y
    c2 = torch.cos(2.0 * xy)
    lead = exx * (
        erfcx(y) * c2 + x * torch.sin(xy) / math.pi * torch.sinc(xy / math.pi)
    )
    tp = E_QUARTER * exx * iex

    def seq_from(anchor_idx, anchor_val):
        seq = [None] * N_TERMS
        seq[anchor_idx] = anchor_val
        t = anchor_val
        for n in range(anchor_idx + 1, N_TERMS):
            t = t * (UP_RATIO[n - 1] * ex)
            seq[n] = t
        t = anchor_val
        for n in range(anchor_idx - 1, -1, -1):
            t = t * ((1.0 / UP_RATIO[n]) * iex)
            seq[n] = t
        return seq

    seq_lo = seq_from(0, E_QUARTER * exx * ex)
    seq_mi = seq_from(N_MID, torch.exp(-((AN[N_MID] - x) ** 2)))
    seq_hi = seq_from(N_TERMS - 1, torch.exp(-((AN[N_TERMS - 1] - x) ** 2)))
    use_lo = x < LO_CUT
    use_hi = x > HI_CUT

    sigma1 = torch.zeros_like(y2)
    sigma23 = torch.zeros_like(x)
    for n in range(N_TERMS):
        denom = 1.0 / (AN2[n] + y2)
        sigma1 = sigma1 + EXP_AN2[n] * denom
        tm = torch.where(use_lo, seq_lo[n], torch.where(use_hi, seq_hi[n], seq_mi[n]))
        sigma23 = sigma23 + (tp + tm) * denom
        if n + 1 < N_TERMS:
            tp = tp * (UP_RATIO[n] * iex)
    return lead + y / math.pi * (-c2 * (exx * sigma1) + 0.5 * sigma23)


def wofz_real_asym(x, y):
    """Re[w(x + iy)] by the asymptotic expansion for large |x + iy|:
    w(z) ~ i/(z sqrt(pi)) (1 + 1/(2z^2) (1 + 3/(2z^2) (1 + 5/(2z^2))))."""
    x = _f32(x)
    y = _f32(y)
    r2 = x * x + y * y
    inv = 1.0 / (2.0 * r2 * r2)
    ar = (x * x - y * y) * inv
    ai = -2.0 * x * y * inv
    pr, pi_ = 3.0 + 15.0 * ar, 15.0 * ai
    pr, pi_ = 1.0 + (ar * pr - ai * pi_), (ar * pi_ + ai * pr)
    pr, pi_ = 1.0 + (ar * pr - ai * pi_), (ar * pi_ + ai * pr)
    scale = 1.0 / (math.sqrt(math.pi) * r2)
    return (y * pr - x * pi_) * scale


def hjert(x, a):
    """H(x, a) = Re[w(x + i a)]: the 916 series where x^2 + a^2 <
    R2_SWITCH, the asymptotic form elsewhere (both evaluated, one selected;
    x clamped to 0 in the far region so the series stays finite)."""
    x = _f32(x)
    a = _f32(a)
    near = x * x + a * a < R2_SWITCH
    xs = torch.where(near, x, torch.zeros_like(x))
    return torch.where(near, wofz_real_916(xs, a), wofz_real_asym(x, a))
