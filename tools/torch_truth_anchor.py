#!/usr/bin/env python3
"""Quadrature evidence and posterior moments of the 1-comp CIV fit with the
PyTorch/CUDA port: the twin of tools/truth_anchor.py.

    python3 tools/torch_truth_anchor.py [specfile] [--brange LO,HI] [--device cuda|cpu]

The 1-component CIV model on ``specfile`` (default testdata/civ_mock_spec.txt)
has three informative dimensions (N, z, b; the continuum is fixed), so its
evidence is a brute-force sum: the log-likelihood on a coarse 41 x 2001 x 41
grid of the unit cube finds the peak, then a 241 x 321 x 241 grid around it
(22 M rows in all, in batches of :data:`BATCH` through
``make_torch_forward(model).loglike_cube``: the fused kernel on the card)
gives logZ by the trapezoid rule in float64 on the host, and the (N, z, b)
marginals' means and sds in physical units.  The same grids, batches and
formulas as the JAX script, so the two differ only in their likelihoods.

``--brange 3,40`` puts every evaluation in the full hjert (the damped
kernel); the default 10,40 is the Harris regime.  Prints the peak, logZ, the
largest edge weight and the moments, and ends with one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: rows per likelihood call (the JAX script's)
BATCH = 16384
#: the coarse grid over the whole cube: N, z, b points
COARSE = (41, 2001, 41)
#: the fine grid around the coarse peak: points, and half-widths in the cube
FINE = (241, 321, 241)
FINE_HALF = (0.14, 4e-3, 0.2)


def make_model(specfile: str = os.path.join(ROOT, "testdata", "civ_mock_spec.txt"),
               brange: Sequence[float] = (10.0, 40.0)):
    """The 1-comp CIV model of tools/truth_anchor.py, with the b prior
    ``brange``."""
    from mcalf_torch.models import AbsorptionModel

    return AbsorptionModel.from_file(
        specfile,
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1), specres=[8.0],
        Nrange=[12.0, 14.5], brange=list(brange), zrange=[2.99, 3.01],
    )


def grid_rows(uN, uz, ub) -> np.ndarray:
    """(len(uN) len(uz) len(ub), 4) float32 unit-cube rows of the grid, N
    slowest, the continuum column at 0.5."""
    G = np.stack(np.meshgrid(uN, uz, ub, indexing="ij"), axis=-1).reshape(-1, 3)
    u = np.zeros((G.shape[0], 4), np.float32)
    u[:, 0] = 0.5
    u[:, 1:] = G
    return u


def torch_loglike(fwd) -> Callable[[np.ndarray], np.ndarray]:
    """(n, 4) float32 numpy rows -> (n,) float64 log L through ``fwd``'s
    ``loglike_cube`` on the device its constants live on."""
    import torch

    device = fwd.d0.device

    def loglike(u: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = fwd.loglike_cube(torch.from_numpy(u).to(device))
        return out.double().cpu().numpy()

    return loglike


def ll_grid(loglike, uN, uz, ub, batch: int = BATCH) -> np.ndarray:
    """log L on the grid, (len(uN), len(uz), len(ub)) float64, in batches
    of ``batch`` rows."""
    u = grid_rows(uN, uz, ub)
    out = np.empty(u.shape[0], np.float64)
    for i in range(0, u.shape[0], batch):
        out[i:i + batch] = loglike(u[i:i + batch])
    return out.reshape(len(uN), len(uz), len(ub))


def trapezoid_weights(x: np.ndarray) -> np.ndarray:
    """Trapezoid-rule weights of the points ``x`` (the JAX script's ``tw``)."""
    g = np.gradient(x)
    g[0] = (x[1] - x[0]) / 2
    g[-1] = (x[-1] - x[-2]) / 2
    return g


def fine_grids(uN, uz, ub, peak: Tuple[int, int, int]):
    """The fine grid around the coarse grid's peak, clipped to the cube."""
    return tuple(np.linspace(max(0, a[i] - h), min(1, a[i] + h), n)
                 for a, i, n, h in zip((uN, uz, ub), peak, FINE, FINE_HALF))


def quadrature_logz(llf: np.ndarray, grids) -> Tuple[float, float, float]:
    """(logZ, peak log L, largest weight on the grid's faces) of log L on
    ``grids`` by the trapezoid rule in float64."""
    m = float(llf.max())
    w = np.exp(llf - m)
    I = np.einsum("i,j,k,ijk->", *(trapezoid_weights(g) for g in grids), w)
    edge = max(w[0].max(), w[-1].max(), w[:, 0, :].max(), w[:, -1, :].max(),
               w[:, :, 0].max(), w[:, :, -1].max())
    return m + float(np.log(I)), m, float(edge)


def moments(llf: np.ndarray, grids, lo, hi) -> Dict[str, Tuple[float, float]]:
    """Posterior mean and sd of N, z and b (parameter columns 1, 2, 3) in
    physical units, from the quadrature weights on ``grids``."""
    m = float(llf.max())
    W = np.einsum("i,j,k,ijk->ijk", *(trapezoid_weights(g) for g in grids), np.exp(llf - m))
    W /= W.sum()
    out = {}
    for name, axis, d in (("N", 0, 1), ("z", 1, 2), ("b", 2, 3)):
        grid = grids[axis]
        marg = W.sum(axis=tuple(a for a in range(3) if a != axis))
        mu_u = float((grid * marg).sum())
        sd_u = float(np.sqrt(((grid - mu_u) ** 2 * marg).sum()))
        out[name] = (float(lo[d] + mu_u * (hi[d] - lo[d])), float(sd_u * (hi[d] - lo[d])))
    return out


def anchor(loglike, lo, hi, batch: int = BATCH, log=print) -> dict:
    """The whole study for one likelihood (``loglike``: (n, 4) float32
    rows -> (n,) float64): coarse peak, fine quadrature, moments, and the
    walls of the two grids."""
    coarse = tuple(np.linspace(0, 1, n) for n in COARSE)
    t0 = time.perf_counter()
    ll = ll_grid(loglike, *coarse, batch=batch)
    t1 = time.perf_counter()
    peak = np.unravel_index(np.argmax(ll), ll.shape)
    peak_u = [float(g[i]) for g, i in zip(coarse, peak)]
    log(f"peak u: {peak_u[0]} {peak_u[1]} {peak_u[2]} ll= {ll[peak]}")
    grids = fine_grids(*coarse, peak)
    llf = ll_grid(loglike, *grids, batch=batch)
    t2 = time.perf_counter()
    logz, m, edge = quadrature_logz(llf, grids)
    log(f"cube quadrature logZ = {logz:.4f}   (peak ll {m:.3f})")
    log(f"max edge weight: {edge:.2e}")
    mom = moments(llf, grids, lo, hi)
    for name, (mu, sd) in mom.items():
        log(f"posterior {name}: mean = {mu:.8f}  sd = {sd:.8f}")
    rows = int(np.prod(COARSE) + np.prod(FINE))
    return {"logz": logz, "peak": m, "edge": edge, "peak_u": peak_u, "moments": mom,
            "rows": rows, "batch": batch, "wall_coarse_s": t1 - t0, "wall_fine_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specfile", nargs="?", default=os.path.join(ROOT, "testdata", "civ_mock_spec.txt"))
    ap.add_argument("--brange", default="10,40", help="b prior in km/s, LO,HI (default 10,40)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from mcalf_torch.models import make_torch_forward

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_truth_anchor: torch finds no CUDA device (--device cpu for the CPU)",
              file=sys.stderr)
        return 2
    brange = [float(x) for x in args.brange.split(",")]
    model = make_model(args.specfile, brange)
    fwd = make_torch_forward(model, args.device)
    res = anchor(torch_loglike(fwd), model.bounds_lo, model.bounds_hi)
    res.update(specfile=os.path.relpath(os.path.abspath(args.specfile), ROOT), brange=brange,
               device=str(fwd.d0.device))
    if fwd.d0.device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
