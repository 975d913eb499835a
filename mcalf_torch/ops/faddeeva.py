"""Harris-regime Voigt--Hjerting functions on torch tensors (float32).

Port of the small-damping half of :mod:`mcalf_tpu.ops.faddeeva`: the
piecewise Dawson integral, the 3-term Harris expansion and its far-wing
tail.  Every function is elementwise with broadcasting (``a`` may be a
per-(sample, transition) column against a pixel axis), computes in
float32 and selects regions with ``torch.where``, exactly as the JAX
versions do, so the two agree to float32 rounding.

The coefficient tables below are the single source of truth for the CUDA
kernel as well: :mod:`mcalf_torch.ops._build` writes them into the
kernel's generated header.

The Algorithm-916 / asymptotic branch (``erfcx``, ``wofz_real_916``,
``wofz_real_asym``, ``hjert``) for strongly damped transitions is not
ported yet.
"""

from __future__ import annotations

import math

import torch

__all__ = [
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
]

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
