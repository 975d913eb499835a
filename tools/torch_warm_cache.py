#!/usr/bin/env python3
"""Pay the port's first-use costs up front: the twin of tools/warm_cache.py.

For each workload, builds the likelihood as the runner builds it for a fit
and calls ``mcalf_torch.sampler.warmup_executables`` (``init_state``, one
re-clustering, two outer steps of ``run_steps`` with the slice loop
captured, ``is_done``, ``finalize``), then prints, apart: the kernels'
build (``nvcc``'s seconds in this process; 0 when the library was built
before), the warm-up's wall seconds, and the slice-loop graph capture's
milliseconds (a warm-up iteration and the capture).

What outlives the process is the kernels' library, built under
``build/mcalf_torch/kernels-<hash>/`` beside the package: a later process
with the same sources loads it without ``nvcc``, as ``bench.py`` starts
from the JAX package's warm compile cache.  The rest (launch geometries,
the mode table's device read, CUDA's initialisation, the allocator's
blocks) stays resident only in the process that called the warm-up.

Workloads: ``flagship`` (testdata/fit.cfg as the CLI runs it),
``hi_forest`` (testdata/hi_forest.cfg at its shipped settings) and
``anchor`` (the 1-component CIV fit of testdata/civ_mock_spec.txt, nlive
200).  Usage:

    python3 tools/torch_warm_cache.py [--workloads flagship,hi_forest] [--device cuda|cpu]

The card unless ``--device cpu`` is given (then the kernels' plain
versions run, and nothing is built).  One JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

WORKLOADS = ("flagship", "hi_forest", "anchor")
_CONFIGS = {"flagship": "fit.cfg", "hi_forest": "hi_forest.cfg"}


def workload(name: str, device):
    """(the forward model, its NSConfig) of a workload on ``device``."""
    from mcalf_torch import runner
    from mcalf_torch.config import readconfig
    from mcalf_torch.models import AbsorptionModel, make_torch_forward
    from mcalf_torch.sampler import NSConfig

    if name == "anchor":
        model = AbsorptionModel.from_file(
            os.path.join(ROOT, "testdata", "civ_mock_spec.txt"), fitrange=[(6180.0, 6220.0)],
            fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 1), specres=[8.0],
            Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
        )
        cfg = NSConfig(ndim=model.ndim, nlive=200, max_samples=12000)
    else:
        cp = readconfig(os.path.join(ROOT, "testdata", _CONFIGS[name]))
        cp["specfile"] = os.path.join(ROOT, cp["specfile"])
        model = runner.build_model(cp)
        _, cfg, _ = runner._sampler_configs(cp, model, device)
    return make_torch_forward(model, device, gpriors=model.gpriors is not None), cfg


def warm(name: str, device, seed: int = 7) -> dict:
    """One workload's warm-up: its wall, the build and the capture apart."""
    import torch

    from mcalf_torch.ops import _build
    from mcalf_torch.sampler import graph, warmup_executables

    fwd, cfg = workload(name, device)
    loads = _build.load.cache_info().misses
    graph.reset_stats()
    t0 = time.perf_counter()
    warmup_executables(fwd.loglike_cube, torch.Generator(device=device).manual_seed(seed),
                       cfg, device)
    wall = time.perf_counter() - t0
    built = _build.load.cache_info().misses > loads
    return dict(workload=name, warmup_s=wall,
                build_s=_build.load().build_seconds if built else 0.0,
                capture_ms=graph.stats["capture_s"] * 1e3, captures=graph.stats["captures"],
                ndim=cfg.ndim, nlive=cfg.nlive, num_repeats=cfg.resolved().num_repeats)


def main(argv=None) -> dict:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default="flagship,hi_forest",
                    help=f"comma-separated, of {', '.join(WORKLOADS)}")
    ap.add_argument("--device", default="cuda", help="cuda[:N] (the default) or cpu")
    args = ap.parse_args(argv)
    names = [w for w in args.workloads.split(",") if w]
    unknown = sorted(set(names) - set(WORKLOADS))
    if unknown:
        ap.error(f"unknown workloads {unknown}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch finds no CUDA device: pass --device cpu to warm up on the CPU")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = []
    for name in names:
        r = warm(name, device)
        out.append(r)
        print(f"{name} (ndim {r['ndim']}, nlive {r['nlive']}, {r['num_repeats']} repeats): "
              f"warm-up {r['warmup_s']:.3f} s, kernel build {r['build_s']:.3f} s, "
              f"{r['captures']} graph capture(s) {r['capture_ms']:.1f} ms  [{kind}]", flush=True)
    result = {"device": kind, "workloads": out}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
