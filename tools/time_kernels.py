"""Device time of the port's two CUDA kernels, for any checkout of the port.

    python3 tools/time_kernels.py [--root DIR]

Imports ``mcalf_torch`` from DIR (default: this checkout) and times its
``fused_loglike`` and ``voigt_tau`` wrappers on one CUDA card with
chip_smoke.py's methods: device time (calls captured in a CUDA graph and
replayed between CUDA events, without the wrapper's host time) and call
time (CUDA events around single calls), and the wrapper's host time per
call (200 calls enqueued back to back on the host clock, before the
synchronisation), on the flagship and the narrow flagship at B=100 and
200, and ``voigt_tau`` alone at its posterior batch, B=1000; then the
sampler's likelihood call, ``loglike_cube``, on the flagship as one seed
(100 rows) and as the 8-seed fleet (800 stacked rows), and the same at b
1-30 km/s (``civ_narrow``): the call's device time (every kernel it
launches) and the ``fused_loglike`` kernel's alone on the same rows' line
tables.  Run it against an older checkout (a ``git archive`` of it) and this
one in turns, one after the other on the same card, to compare two
versions of a kernel: the inputs are the same in both, made from a seed.
Prints one line per cell, the card's name and power limit, and a JSON line
with every time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _host_us(fn, n=200):
    """Host time of one call: n calls enqueued back to back, timed on the
    host clock before the synchronisation that waits for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / n


def _likelihood_calls(smoke, smi):
    """The flagship's ``loglike_cube`` as one seed and as an 8-seed fleet,
    and the same fit at b 1-30 km/s (``benchmark/configs/civ_narrow.cfg``,
    every transition MODE_HJERT): the call's device time and the fused
    kernel's alone on its rows."""
    for name, brange in (("flagship", None), ("civ_narrow", [1.0, 30.0])):
        yield from _likelihood_calls_of(smoke, smi, name, brange)


def _likelihood_calls_of(smoke, smi, name, brange):
    import torch

    from mcalf_torch.models import AbsorptionModel, make_torch_forward
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.ops import voigt_cuda

    kw = dict(smoke.MODELS["flagship"], **({} if brange is None else {"brange": brange}))
    model = AbsorptionModel.from_file(str(smoke.TESTDATA / "civ_mock_spec_multicomp.txt"), **kw)
    for Q in (1, 8):
        if Q == 1:
            fwd, prob = make_torch_forward(model, "cuda"), None
        else:
            fwd = tm.make_stacked_forward(*stack_problems([model] * Q), "cuda")
            prob = torch.arange(Q, device="cuda", dtype=torch.int32).repeat_interleave(100)
        s = fwd.static
        u = smoke._batch(s.ndim, 100 * Q, False, seed=Q, layout=None)
        call = (lambda: fwd.loglike_cube(u)) if Q == 1 else (lambda: fwd.loglike_cube(u, prob))
        c = fwd.consts() if Q == 1 else tm.row_consts(fwd.consts(), prob)
        dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
        args = tm.fused_args(tm.cube_to_params_core(u, c), c, s, dz=dz, prob=prob)
        fused = lambda: voigt_cuda.fused_loglike(*args, half=s.half, asymm=False, prob=prob)
        rec = {"call_ms": [smoke._device_ms(call), smoke._device_ms(call)],
               "fused_ms": [smoke._device_ms(fused), smoke._device_ms(fused)]}
        prefix = "" if name == "flagship" else f"{name} "
        print(f"[time] {name} loglike_cube, {Q} x 100 rows: call device "
              f"{rec['call_ms'][0]:.4f}/{rec['call_ms'][1]:.4f} ms, fused_loglike alone "
              f"{rec['fused_ms'][0]:.4f}/{rec['fused_ms'][1]:.4f} ms  [{smi}]")
        yield f"{prefix}loglike_cube Q={Q} x B=100", rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose mcalf_torch is timed")
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    # this checkout's chip_smoke.py: its helpers import mcalf_torch lazily,
    # so they find the one under --root
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    if Path(voigt_cuda.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {voigt_cuda.__file__}, not the one under {root}")
    smi = smoke.phase_device()
    smoke.phase_build()
    out = {"root": str(root), "card": smi}
    for name in ("flagship", "narrow"):
        fwd = make_torch_forward(smoke._model(name), "cuda")
        s = fwd.static
        for B in (100, 200, 1000):
            args = smoke._fused_args(fwd, smoke._batch(s.ndim, B, False, seed=B, layout=None))[1]
            targs = smoke._tau_args(args)
            tau = lambda: voigt_cuda.voigt_tau(*targs)
            rec = {
                "tau_ms": [smoke._device_ms(tau), smoke._device_ms(tau)],
                "tau_call_ms": smoke._median_ms(tau),
                "tau_host_us": _host_us(tau),
            }
            text = (f"voigt_tau device {rec['tau_ms'][0]:.4f}/{rec['tau_ms'][1]:.4f} ms, "
                    f"call {rec['tau_call_ms']:.4f} ms, host {rec['tau_host_us']:.1f} us per call")
            if B < 1000:  # the fused kernel's batches are the fit's
                fused = lambda: voigt_cuda.fused_loglike(*args, half=s.half, asymm=False)
                rec.update(
                    fused_ms=[smoke._device_ms(fused), smoke._device_ms(fused)],
                    fused_call_ms=smoke._median_ms(fused),
                    fused_host_us=_host_us(fused),
                )
                text = (f"fused device {rec['fused_ms'][0]:.4f}/{rec['fused_ms'][1]:.4f} ms, "
                        f"call {rec['fused_call_ms']:.4f} ms, host "
                        f"{rec['fused_host_us']:.1f} us per call; " + text)
            out[f"{name} B={B}"] = rec
            print(f"[time] {name} B={B}: {text}  [{smi}]")
    out.update(dict(_likelihood_calls(smoke, smi)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
