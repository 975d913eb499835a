"""Device time of one chord slice iteration's bookkeeping on a card: the
slice kernels (``mcalf_torch/ops/slice_cuda.py``) against the torch ops
they replace (``sampler/nested.py::_slice_step_ops``).

    python3 tools/time_slice_step.py

At the flagship's widths (ndim 34, 100 chains a problem, 816 passes, 30
shrinks) as one problem and as the 8-problem fleet: 64 iterations captured
in a CUDA graph and replayed between CUDA events, with a likelihood that
launches nothing (each row's value read from a table, about half of them
above the constraint), so the time is the bookkeeping's alone; then the
same with each problem's uniform draw (``_slice_iter``).  Prints one line
per case and a JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcalf_torch.sampler import NSConfig  # noqa: E402
from mcalf_torch.sampler import nested as tn  # noqa: E402

NDIM, B, NREP, ITERATIONS, REPLAYS = 34, 100, 816, 64, 10


def _loop(Q, dev, seed=0):
    rng = np.random.default_rng(seed)
    cfg = NSConfig(ndim=NDIM, nlive=2 * B, num_delete=B, num_repeats=NREP).resolved()
    n = rng.normal(size=(Q, NREP, B, NDIM))
    pools = torch.tensor(0.1 * n / np.linalg.norm(n, axis=-1, keepdims=True),
                         dtype=torch.float32, device=dev)
    table = torch.tensor(rng.normal(size=Q * B), dtype=torch.float32, device=dev)
    gens = [torch.Generator(device=dev).manual_seed(seed + q) for q in range(Q)]
    x = tn._fixed(lambda u, prob: table, gens, pools, torch.zeros((Q,), device=dev),
                  list(range(Q)), cfg)
    u = torch.tensor(rng.uniform(0.2, 0.8, (Q, B, NDIM)), dtype=torch.float32, device=dev)
    c = tn._init_loop_carry(u, torch.zeros((Q, B), device=dev), x)
    x.r.uniform_(generator=gens[0])
    return x, c


def _kernel_us(graph):
    """Device µs of each kernel a replay of ``graph`` runs, by the profiler
    (the sum of its runs over its count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.count:
            out[e.key[:60]] = round(e.self_device_time_total / e.count, 3)
    return out


def _device_us(body, gens):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    for gen in gens:
        g.register_generator_state(gen)
    with torch.cuda.graph(g):
        for _ in range(ITERATIONS):
            body()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPLAYS):
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(1e3 * start.elapsed_time(end) / ITERATIONS)
    return min(times), float(np.median(times)), _kernel_us(g)


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi}
    for Q in (1, 8):
        for name, fn in (("kernels", tn._slice_step), ("ops", tn._slice_step_ops)):
            x, c = _loop(Q, dev)
            out[f"Q{Q}_{name}_us"] = _device_us(lambda: fn(c, x), [])
            x, c = _loop(Q, dev)
            if name == "kernels":
                step = lambda: tn._slice_iter(c, x)  # noqa: E731
            else:
                def step():
                    for q in range(Q):
                        torch.rand((B,), generator=x.gens[q], device=dev, out=x.r[q])
                    tn._slice_step_ops(c, x)
            out[f"Q{Q}_{name}_with_draws_us"] = _device_us(step, x.gens)
            print(f"Q={Q} {name}: bookkeeping {out[f'Q{Q}_{name}_us'][:2]} us, with the draws "
                  f"{out[f'Q{Q}_{name}_with_draws_us'][:2]} us (min, median per iteration)")
            if name == "kernels":
                print(f"  per kernel run (us): {out[f'Q{Q}_{name}_with_draws_us'][2]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
