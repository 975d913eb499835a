"""FLOP census and roofline bound of the port's two kernels at the shapes
chip_smoke.py times, from the JAX package's jaxpr census.

    JAX_PLATFORMS=cpu python tools/kernel_census.py

For the flagship (testdata/fit.cfg: 22 windowed Harris transitions) and the
narrow flagship (the same with brange = 3, 40: 22 strongly damped
transitions), at B = 100 and 200, it censuses on the CPU, with
``mcalf_tpu.utils.flops.flop_census``:

* the fused likelihood: ``make_jax_forward(..., use_pallas=False).loglike``
  on the XLA path, the math of the fused kernel (and of ``_ll_kernel``);
* the tau synthesis alone: the per-transition H sum of the XLA
  ``reconstruct_core``, the math of the tau kernel (and of ``_tau_kernel``).

The bound is the larger of census FLOP / 67 TFLOP/s (an H100 SXM's float32
rate outside the tensor cores, at 700 W) and the bytes the call must move
(each input read once, each output written once) / 3.35 TB/s.  The census
counts both sides of every select: ``hjert`` evaluates the 916 series and
the asymptotic form on every pixel, ``hjert_harris`` all four Dawson
regions, so it counts more than a kernel that branches per pixel needs
(chip_smoke.py's bound counts per branch taken).
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from mcalf_tpu.models import AbsorptionModel, make_jax_forward
from mcalf_tpu.models import jax_model as jm
from mcalf_tpu.ops.faddeeva import hjert, hjert_harris, hjert_harris_win
from mcalf_tpu.utils.flops import flop_census

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    specres=[8.0], Nrange=[12.0, 14.5], zrange=[2.99, 3.01], ncomp=(8, 11),
)
MODELS = {
    "flagship": dict(_CIV, brange=[10.0, 40.0]),
    "narrow": dict(_CIV, brange=[3.0, 40.0]),
}


def tau_fn(s, c):
    """tau (B, P) from the (B, T) tables, as the XLA reconstruct_core sums
    it."""
    d0, cw = jnp.asarray(c["d0"]), jnp.asarray(c["c_over_wave"])

    def tau(dz, gain, av, dnu):
        idnu = 1.0 / dnu
        acc = jnp.zeros((dz.shape[0], cw.shape[0]), jnp.float32)
        for t in range(s.ntrans):
            u = (d0[t] + dz[:, t : t + 1] * cw) * idnu[:, t : t + 1]
            a = av[:, t : t + 1]
            if s.win_tmin[t] > 0.0:
                H = hjert_harris_win(u, a, s.win_tmin[t])
            elif s.harris[t]:
                H = hjert_harris(u, a)
            else:
                H = hjert(u, a)
            acc = acc + gain[:, t : t + 1] * H
        return acc

    return tau


def main() -> None:
    print("model    B    kernel         census FLOP   FLOP/eval   bytes     bound ms  bound by")
    for name, kw in MODELS.items():
        m = AbsorptionModel.from_file(str(TESTDATA / "civ_mock_spec_multicomp.txt"), **kw)
        s = jm.static_spec(m)
        c = jm.build_consts(m)
        T, P, K = s.ntrans, s.npix, 2 * s.half + 1
        fwd = make_jax_forward(m, use_pallas=False)
        for B in (100, 200):
            p = np.asarray(fwd.cube_to_params(np.full((B, m.ndim), 0.5, np.float32)))
            tables = [np.ones((B, T), np.float32)] * 4
            common = 4 * (4 * B * T + T * P + P + 2 * T)
            for kernel, flops, nbytes in (
                ("fused_loglike", flop_census(fwd.loglike, p).flops,
                 common + 4 * (3 * P + B * K + B + 3 * B)),
                ("voigt_tau", flop_census(tau_fn(s, c), *tables).flops,
                 common + 4 * B * P),
            ):
                t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
                print(
                    f"{name:8s} {B:4d} {kernel:14s} {flops:13d} {flops // B:10d} "
                    f"{nbytes:9d} {1e3 * max(t_ops, t_bytes):9.5f}  "
                    f"{'operations' if t_ops >= t_bytes else 'bytes'}"
                )


if __name__ == "__main__":
    main()
