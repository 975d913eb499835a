"""The tau kernel's design steps, each timed against the one before.

    python3 tools/tau_steps.py [--parent DIR] [--out DIR]

Builds ``mcalf_torch/csrc`` and, with ``--parent``, an older checkout's
sources (a ``git archive`` of it) whose ``mcalf_voigt_tau`` launches one CTA
per (sample, 256-pixel tile), called as tools/compare_tau.py calls it.  On the flagship and the narrow flagship at B
in {100, 200, 1000} (inputs made from a seed, as chip_smoke.py makes them)
it times, by chip_smoke.py's graph method, the parent kernel and this
kernel at these geometries:

* ``step1``: one sample per group (S = 1), 256-pixel tiles: the two
  instantiations picked on the host, on the parent's grid;
* ``step2``: S in {2, 4} on the same tiles (S = 2 at most for the damped
  kernel);
* ``tiles``: each S with tiles of 64, 128 or 256 pixels;
* ``final``: ``voigt_cuda.tau_geometry``, what the wrapper launches.

Each variant's tau is checked bit for bit against the first one's (the
parent's, when given).  Prints ptxas's registers and spills per
instantiation, each geometry's resident CTAs per SM, and one line per time
with the card's name and power limit; writes the lines to DIR/tau_steps.txt
and every number to DIR/tau_steps.json (DIR: chiprun_out by default).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SAMPLES = (1, 2, 4)
TILES = (64, 128)  # besides step1's and step2's 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="older checkout whose tau kernel is the baseline")
    ap.add_argument("--out", default=str(HERE / "chiprun_out"))
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import _build, voigt_cuda

    lines = []

    def say(text):
        print(text)
        lines.append(text)

    smi = smoke.phase_device()
    parent_lib = None
    if args.parent:
        spec = importlib.util.spec_from_file_location("compare_tau", HERE / "tools" / "compare_tau.py")
        compare = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(compare)
        own = _build.CSRC
        _build.CSRC = Path(args.parent).resolve() / "mcalf_torch" / "csrc"
        _build.load.cache_clear()
        parent_lib = _build.load().lib
        _build.CSRC = own
        _build.load.cache_clear()
    built = _build.load()
    out = {"card": smi, "ptxas": [], "cells": {}}
    say(f"[steps] built {built.path.name} in {built.build_seconds:.2f} s")
    for name, line in smoke.ptxas_counts(built.log):
        if name.startswith("voigt_tau"):
            out["ptxas"].append(f"{name}: {line}")
            say(f"[steps] ptxas {name}: {line}")

    # the wrapper against the plain version first, partial last groups included
    for model in ("flagship", "narrow", "mixed"):
        fwd = make_torch_forward(smoke._model(model), "cuda")
        for B in (1, 13, 203):
            targs = smoke._tau_args(smoke._fused_args(
                fwd, smoke._batch(fwd.static.ndim, B, False, seed=B, layout=None))[1])
            k, q = voigt_cuda.voigt_tau(*targs), voigt_cuda.voigt_tau_plain(*targs)
            err = float(((k - q).abs() / (q.abs() + 1e-3)).max())
            say(f"[steps] {model} B={B}: max |dtau|/(|tau|+1e-3) {err:.3g}")
            if not err < 3e-5:
                raise AssertionError(f"{model} B={B}: tau differs from the plain version")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["sms"] = sms
    for model in ("flagship", "narrow"):
        fwd = make_torch_forward(smoke._model(model), "cuda")
        s = fwd.static
        damped = voigt_cuda.MODE_HJERT in fwd.modes.tolist()
        T, P = s.ntrans, s.npix
        for B in (100, 200, 1000):
            targs = smoke._tau_args(smoke._fused_args(
                fwd, smoke._batch(s.ndim, B, False, seed=B, layout=None))[1])
            named = tuple(zip(("dz", "gain", "av", "dnu", "d0", "cw", "tmin"), targs[:7]))
            modes = targs[7]
            variants = {}
            if parent_lib is not None:
                variants["parent"] = lambda targs=targs: compare._one_sample_tau(parent_lib, targs)
            samples = [S for S in SAMPLES if S <= voigt_cuda.TAU_MAX_SAMPLES[damped]]
            geos = {"step1 S=1 tile 256": voigt_cuda._tau_layout(B, T, P, 1, 256)}
            for S in samples[1:]:
                geos[f"step2 S={S} tile 256"] = voigt_cuda._tau_layout(B, T, P, S, 256)
            for S in samples:
                for t in TILES:
                    geos[f"tiles S={S} tile {t}"] = voigt_cuda._tau_layout(B, T, P, S, t)
            geos["final"] = voigt_cuda.tau_geometry(B, T, P, damped, sms=sms)
            for key, geo in geos.items():
                def run(geo=geo, named=named, modes=modes, B=B):
                    tau = torch.empty((B, P), dtype=torch.float32, device="cuda")
                    voigt_cuda._launch_tau(named, modes, tau, damped, geo)
                    return tau
                variants[key] = run
            want = None
            for key, fn in variants.items():
                tau = fn()
                torch.cuda.synchronize()
                if want is None:
                    want = tau
                ndiff = int((tau != want).sum())
                if ndiff:
                    raise AssertionError(f"{model} B={B} {key}: {ndiff} tau values differ")
            cell = {}
            for key, fn in variants.items():  # in turns: each twice, the order reversed
                cell[key] = [smoke._device_ms(fn)]
            for key, fn in reversed(variants.items()):
                cell[key].append(smoke._device_ms(fn))
            bound, by = smoke._bound(targs, False)
            occ = {key: voigt_cuda.tau_occupancy(damped, g) for key, g in geos.items()}
            out["cells"][f"{model} B={B}"] = {
                "bound_ms": bound, "bound_by": by, "ms": cell, "ctas_per_sm": occ,
                "geometry": {key: g._asdict() for key, g in geos.items()},
            }
            for key, (a, b) in cell.items():
                g = geos.get(key)
                say(f"[steps] {model} B={B} {key}: {a:.4f}/{b:.4f} ms"
                    + (f" (S={g.samples}, {g.grid} CTAs of {g.threads}, {occ[key]} per SM)"
                       if g else "")
                    + f", bound {bound:.4f} ms ({by}), tau bit-identical  [{smi}]")
    where = Path(args.out)
    where.mkdir(parents=True, exist_ok=True)
    (where / "tau_steps.json").write_text(json.dumps(out, indent=1))
    (where / "tau_steps.txt").write_text("\n".join(lines) + "\n")
    print(f"[steps] wrote {where}/tau_steps.json and tau_steps.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
