"""Smoke run of the PyTorch/CUDA port (mcalf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line:

1. device: requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as nvidia-smi gives them;
2. build: compiles the fused likelihood kernel from mcalf_torch/csrc;
3. kernel vs plain: the kernel against its plain PyTorch version on the
   same inputs at the flagship shapes (T=22, P=1999, K=23), B in {100, 37,
   1}, a prior-spread and a z-clustered batch, plus the asymmlike
   multicomponent model: log L to rtol 1e-5 / atol 0.05 with the -inf
   pattern exact (the JAX package's fused-vs-XLA tolerance);
4. timing: kernel vs plain at B=100 and B=200 (median of CUDA-event
   timings);
5. the slice: ``mcalf_torch.cli.main`` on a copy of testdata/fit.cfg at
   full width (ndim 34, nlive 200, B=100, canon_layout, the kernel on),
   depth cut by max_samples; checks the chain files, logZ and that every
   likelihood batch went through the kernel;
6. statistical anchor: the 1-comp CIV fit with 3 seeds against the
   quadrature evidence of testdata/civ_mock_spec.txt, 4985.51, within 2x
   the mean logzerr.

Then one JSON line with the kernels' launch counts, errors and times, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "testdata"
QUADRATURE_LOGZ = 4985.51  # 1-comp CIV on testdata/civ_mock_spec.txt
SLICE_MAX_SAMPLES = 1000
SLICE_NUM_REPEATS = 544


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)  # as nvidia-smi gives it: name, power limit
    print(
        f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}: {torch.cuda.get_device_name(0)}"
    )
    return smi


def phase_build() -> None:
    from mcalf_torch.ops._build import load

    built = load("fused_loglike")
    info = [ln.strip() for ln in built.log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2 build] {built.path.name} built in {built.build_seconds:.2f} s")
    for ln in info:
        print(f"[2 build] ptxas: {ln}")


def _flagship(asymm: bool = False):
    from mcalf_torch.models import AbsorptionModel

    if asymm:
        return AbsorptionModel.from_file(
            str(TESTDATA / "civ_mock_spec_multicomp.txt"),
            fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
            ncomp=(2, 4), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
            brange=[10.0, 40.0], zrange=[2.99, 3.01], Asymmlike=True,
        )
    return AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11), specres=[8.0], Nrange=[12.0, 14.5],
        brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )


def _batch(ndim, B, clustered, seed, layout):
    """Unit-cube batch: spread over the prior, or with every component's
    redshift clustered near one value (a converged-phase batch)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.02, 0.98, size=(B, ndim))
    if clustered and layout is not None:
        startind, ncompmax = layout[0], layout[1]
        zcols = [startind + 2 + 3 * i for i in range(ncompmax)]
        u[:, zcols] = 0.5 + rng.normal(0.0, 2e-3, size=(B, len(zcols)))
    return torch.from_numpy(u.astype(np.float32)).cuda()


def _kernel_and_plain(fwd, u):
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.ops import voigt_cuda

    s, c = fwd.static, fwd.consts()
    dz = (u[..., c["u_zidx"]] - 0.5) * c["zspan"]
    p = tm.cube_to_params_core(u, c)
    args = tm.fused_args(p, c, s, dz=dz)
    kw = dict(half=s.half, asymm=s.asymmlike)
    k = voigt_cuda.fused_loglike(*args, harris=s.harris, **kw)
    q = voigt_cuda.fused_loglike_plain(*args, **kw)
    return k, q, tm.loglike_from_fused(p, c, s, *k), tm.loglike_from_fused(p, c, s, *q), args


def phase_kernel_check() -> float:
    from mcalf_torch.models import make_torch_forward

    worst = 0.0
    for name, model in (("flagship", _flagship()), ("asymmlike", _flagship(True))):
        fwd = make_torch_forward(model, "cuda")
        s = fwd.static
        assert all(s.harris)
        for B in (100, 37, 1):
            for clustered in (False, True):
                u = _batch(s.ndim, B, clustered, seed=B + 7 * clustered,
                           layout=model.canon_layout())
                k, q, lk, lp, _ = _kernel_and_plain(fwd, u)
                torch.cuda.synchronize()
                ck = k[0].double().cpu().numpy()
                cq = q[0].double().cpu().numpy()
                if not np.allclose(ck, cq, rtol=1e-5, atol=0.1):
                    raise AssertionError(
                        f"{name} B={B}: max |dchi2| = {np.max(np.abs(ck - cq))}"
                    )
                lk = lk.double().cpu().numpy()
                lp = lp.double().cpu().numpy()
                if not np.array_equal(np.isfinite(lk), np.isfinite(lp)):
                    raise AssertionError(f"{name} B={B}: -inf pattern differs")
                fin = np.isfinite(lk)
                err = float(np.max(np.abs(lk[fin] - lp[fin]), initial=0.0))
                if not np.allclose(lk[fin], lp[fin], rtol=1e-5, atol=0.05):
                    raise AssertionError(f"{name} B={B}: max |dlogL| = {err}")
                worst = max(worst, err)
                print(
                    f"[3 kernel] {name} T={s.ntrans} P={s.npix} K={2 * s.half + 1} "
                    f"B={B} {'z-clustered' if clustered else 'spread'}: "
                    f"max |dlogL| {err:.3g}, finite {int(fin.sum())}/{B}"
                )
    return worst


def _median_ms(fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_timing(smi: str) -> dict:
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    fwd = make_torch_forward(_flagship(), "cuda")
    s = fwd.static
    out = {}
    for B in (100, 200):
        u = _batch(s.ndim, B, False, seed=B, layout=None)
        args = _kernel_and_plain(fwd, u)[-1]
        kw = dict(half=s.half, asymm=False)
        ms_k = _median_ms(lambda: voigt_cuda.fused_loglike(*args, harris=s.harris, **kw))
        ms_p = _median_ms(lambda: voigt_cuda.fused_loglike_plain(*args, **kw), reps=10)
        ms_cube = _median_ms(lambda: fwd.loglike_cube(u))
        out[B] = (ms_k, ms_p)
        print(
            f"[4 timing] B={B}: kernel {ms_k * 1e3 / B:.3f} us/eval "
            f"({B / ms_k * 1e3:.4g} evals/s, {ms_k:.4f} ms/call); plain "
            f"{ms_p * 1e3 / B:.3f} us/eval ({B / ms_p * 1e3:.4g} evals/s); "
            f"loglike_cube {ms_cube:.4f} ms/call  [{smi}]"
        )
    return out


def _write_cfg(path: Path, outdir: Path) -> None:
    text = (TESTDATA / "fit.cfg").read_text()
    text = text.replace("datadir = testdata/", f"datadir = {TESTDATA}/")
    text = text.replace("outdir = testdata/output/", f"outdir = {outdir}/")
    text = text.replace("doplot = True", "doplot = False")
    text += (
        "\n[ns_settings]\n"
        f"max_samples = {SLICE_MAX_SAMPLES}\n"
        f"num_repeats = {SLICE_NUM_REPEATS}\n"
    )
    path.write_text(text)


def phase_slice(tmp: Path) -> dict:
    from mcalf_torch import cli, runner
    from mcalf_torch.ops import voigt_cuda

    cfg = tmp / "fit.cfg"
    _write_cfg(cfg, tmp)
    results = []
    run_fit = runner.run_fit

    def recording_run_fit(*a, **k):
        results.append(run_fit(*a, **k))
        return results[-1]

    runner.run_fit = recording_run_fit
    try:
        voigt_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main([str(cfg)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = voigt_cuda.launches
    finally:
        runner.run_fit = run_fit
    if rc != 0 or len(results) != 1:
        raise AssertionError(f"cli.main returned {rc}, fits run: {len(results)}")
    res, base = results[0]
    stats = Path(base + ".stats").read_text().splitlines()
    head = stats[0].split()
    if head[0] != "log(Z)" or not math.isfinite(float(head[2])):
        raise AssertionError(f"bad .stats: {stats}")
    logz = float(head[2])
    eq = np.loadtxt(base + "_equal_weights.txt", ndmin=2)
    if eq.shape[1] != 2 + 34 or not np.all(np.isfinite(eq)):
        raise AssertionError(f"bad _equal_weights.txt shape {eq.shape}")
    nlive, B = 200, 100
    batches = 1 + (res.n_like - nlive) // B
    if launches < batches:
        raise AssertionError(f"{launches} kernel launches < {batches} batches")
    print(
        f"[5 slice] flagship ndim=34 nlive=200 B=100 num_repeats="
        f"{SLICE_NUM_REPEATS} max_samples={SLICE_MAX_SAMPLES}: "
        f"{res.n_iter} steps, n_like={res.n_like}, wall {wall:.2f} s, "
        f"{res.n_like / wall:.4g} evals/s, logZ={logz:.3f} "
        f"(+/- {float(res.logzerr):.3f}, unconverged by design), "
        f"kernel launches {launches} >= batches {batches}, "
        f"equal-weight rows {eq.shape[0]}"
    )
    return {"launches": launches, "wall": wall, "n_like": res.n_like}


def phase_anchor() -> None:
    from mcalf_torch.models import AbsorptionModel, make_torch_forward
    from mcalf_torch.sampler import NSConfig, insertion_rank_test, nested_sample

    model = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 1), specres=[8.0],
        Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )
    fwd = make_torch_forward(model, "cuda")
    cfg = NSConfig(ndim=4, nlive=200, max_samples=12000)
    logz, err = [], []
    for seed in (0, 1, 2):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        res = nested_sample(fwd.loglike_cube, gen, cfg, "cuda").numpy()
        wall = time.perf_counter() - t0
        p = insertion_rank_test(res, cfg).p_value
        logz.append(float(res.logz))
        err.append(float(res.logzerr))
        print(
            f"[6 anchor] seed {seed}: logZ {res.logz:.3f} +/- {res.logzerr:.3f}, "
            f"rank p {p:.4f}, n_like {res.n_like}, {res.n_iter} steps, "
            f"converged={res.termination_reason == 0}, wall {wall:.2f} s"
        )
    mean, merr = float(np.mean(logz)), float(np.mean(err))
    ok = abs(mean - QUADRATURE_LOGZ) < 2.0 * merr
    print(
        f"[6 anchor] mean logZ {mean:.3f} vs quadrature {QUADRATURE_LOGZ}: "
        f"|d| {abs(mean - QUADRATURE_LOGZ):.3f} < 2 x mean logzerr "
        f"{2 * merr:.3f}: {ok}"
    )
    if not ok:
        raise AssertionError("1-comp anchor outside 2x mean logzerr")


def main() -> int:
    smi = phase_device()
    phase_build()
    worst = phase_kernel_check()
    timing = phase_timing(smi)
    tmp = ROOT / "build" / "chip_smoke"  # git-ignored
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        sl = phase_slice(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_anchor()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    ms_k, ms_p = timing[100]
    print(json.dumps({"kernels": [{
        "name": "fused_loglike",
        "route": "cuda",
        "source": "mcalf_torch/csrc/fused_loglike.cu",
        "replaces": "mcalf_tpu/ops/voigt_pallas.py:213",
        "launches": sl["launches"],
        "max_abs_err": worst,
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
