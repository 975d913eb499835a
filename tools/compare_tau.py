"""Is tau bit for bit the same as an older checkout's kernel computes it?

    python3 tools/compare_tau.py --parent DIR

Builds the CUDA sources of DIR/mcalf_torch/csrc (an older checkout, e.g. a
``git archive`` of it) and this checkout's, with this checkout's
``mcalf_torch/ops/_build.py``, and runs both ``voigt_tau`` kernels on the
same inputs: the flagship, the narrow flagship and the mixed model at B in
{1, 100, 1000}, made from a seed.  This checkout's kernel, and an older one
with the same C entry point (``mcalf_voigt_tau_groups``), run through this
checkout's wrapper; an older one with the one-sample entry point
``mcalf_voigt_tau`` (one CTA per sample and 256-pixel tile) is called
through that.  Both kernels share the per-pixel tau arithmetic of the fused
kernel (``csrc/voigt_h.cuh``).  Prints, per model and batch, the number of
values of tau that differ and the largest difference, and exits 1 if any
differs.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="older checkout to compare with")
    csrc_parent = Path(ap.parse_args().parent).resolve() / "mcalf_torch" / "csrc"
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import _build, voigt_cuda

    smi = smoke.phase_device()
    inputs = {}
    for name in ("flagship", "narrow", "mixed"):
        fwd = make_torch_forward(smoke._model(name), "cuda")
        for B in (1, 100, 1000):
            u = smoke._batch(fwd.static.ndim, B, False, seed=17 + B, layout=None)
            inputs[name, B] = smoke._tau_args(smoke._fused_args(fwd, u)[1])
    taus = {}
    for which, csrc in (("this", _build.CSRC), ("parent", csrc_parent)):
        _build.CSRC = csrc
        _build.load.cache_clear()
        voigt_cuda._tau_fn.cache_clear()
        lib = _build.load().lib
        if hasattr(lib, "mcalf_voigt_tau_groups"):
            taus[which] = {k: voigt_cuda.voigt_tau(*a) for k, a in inputs.items()}
        else:
            taus[which] = {k: _one_sample_tau(lib, a) for k, a in inputs.items()}
        torch.cuda.synchronize()
    same = True
    for (name, B) in inputs:
        a, b = taus["this"][name, B], taus["parent"][name, B]
        ndiff = int((a != b).sum())
        same &= ndiff == 0
        print(f"[tau bits] {name} B={B} P={a.shape[1]}: {ndiff} of {a.numel()} tau "
              f"values differ, max |dtau| {float((a - b).abs().max()):.3g}  [{smi}]")
    return 0 if same else 1


def _one_sample_tau(lib, args):
    """tau from a library whose tau kernel has the one-sample entry point
    mcalf_voigt_tau(9 pointers, B, T, P, stream)."""
    import torch

    fn = lib.mcalf_voigt_tau
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    B, T = args[0].shape
    P = args[5].shape[0]
    tau = torch.empty((B, P), dtype=torch.float32, device=args[0].device)
    err = fn(*(x.data_ptr() for x in args), tau.data_ptr(), B, T, P,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the older tau kernel's launch failed: CUDA error {err}")
    return tau


if __name__ == "__main__":
    sys.exit(main())
