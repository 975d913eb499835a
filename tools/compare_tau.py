"""Is tau bit for bit the same as an older checkout's kernel computes it?

    python3 tools/compare_tau.py --parent DIR

Builds the CUDA sources of DIR/mcalf_torch/csrc (an older checkout, e.g. a
``git archive`` of it) and this checkout's, with this checkout's
``mcalf_torch/ops/_build.py``, and runs both ``voigt_tau`` kernels through
this checkout's wrapper (the C entry point ``mcalf_voigt_tau`` has kept its
signature) on the same inputs: the flagship, the narrow flagship and the
mixed model at B=100, made from a seed.  Both kernels share the per-pixel tau code of the fused kernel
(``csrc/voigt_h.cuh``), so equal tau means the fused kernel's per-pixel
model flux is unchanged too.  Prints, per model, the number of pixels whose
tau differs and the largest difference, and exits 1 if any differs.
"""

from __future__ import annotations

import argparse
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
        u = smoke._batch(fwd.static.ndim, 100, False, seed=17, layout=None)
        inputs[name] = smoke._tau_args(smoke._fused_args(fwd, u)[1])
    taus = {}
    for which, csrc in (("this", _build.CSRC), ("parent", csrc_parent)):
        _build.CSRC = csrc
        _build.load.cache_clear()
        voigt_cuda._tau_fn.cache_clear()
        taus[which] = {n: voigt_cuda.voigt_tau(*a) for n, a in inputs.items()}
        torch.cuda.synchronize()
    same = True
    for name in inputs:
        a, b = taus["this"][name], taus["parent"][name]
        ndiff = int((a != b).sum())
        same &= ndiff == 0
        print(f"[tau bits] {name} B=100 P={a.shape[1]}: {ndiff} of {a.numel()} tau "
              f"values differ, max |dtau| {float((a - b).abs().max()):.3g}  [{smi}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
