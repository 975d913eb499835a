"""Smoke run of the PyTorch/CUDA port (mcalf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing lines tagged with its number:

1. device: requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as nvidia-smi gives them;
2. build: compiles the kernels (csrc/fused_loglike.cu, csrc/voigt_tau.cu
   and the slice sampler's csrc/slice_step.cu) with one nvcc call and
   prints ptxas's registers and spills per kernel instantiation (each
   physics kernel's Harris-only and damped one, the fused kernel's each
   from (B, T) tables and from the unit cube; slice_propose and
   slice_update) and of the functions they call out of line, and the fused
   kernel's beside their 48 and 80 registers before the problem axis;
3. fused kernel vs plain, the same inputs at full width, B in {100, 37, 1},
   a prior-spread and a z-clustered batch, log L to rtol 1e-5 / atol 0.05
   with the -inf pattern exact (the JAX package's fused-vs-XLA tolerance):
   the flagship (T=22, P=1999, K=23, all windowed Harris) and the asymmlike
   multicomponent model; then the strong-damping branch on the narrow
   flagship (fit.cfg with brange = 3, 40: all 22 transitions in the full
   hjert) and the mixed model (CIV 1548 + HI 1215 + filler, T=7, windowed
   Harris and full hjert); then ragged spectra made from the flagship's and
   the narrow flagship's by resampling (P in {1, 23, 255, 257, 2049, 5000}
   with half in {0, 11} where P > 2 half, and P = 65536 with T = 2, each at
   B in {1, 100}), chi^2 to rtol 1e-5 / atol 0.1 and n4/n5 within 1, and two
   launches on the same inputs bit-identical; then the problem axis: two
   different problems stacked (the flagship, and the flagship model on a
   shorter fit range padded to its 1999 pixels; the same for the asymmlike
   model), their rows interleaved, B in {100, 37, 1} per problem, against
   the plain version at the reference tolerance and every stacked row bit
   for bit the single-problem launch's.  Beside each launch from (B, T)
   tables, the sampler's launch (``voigt_cuda.fused_loglike_cube``: the
   same rows as unit-cube points) against its plain twin at the same
   tolerance with the -inf pattern exact, and its log L bit for bit the
   table entry's through the glue; then the fleet's shape, 8 x 100 stacked
   flagship rows, the same three ways;
4. tau kernel vs plain on the flagship, the narrow flagship and the mixed
   model, B in {100, 200, 13, 1000}: |dtau| / (|tau| + 1e-3) < 3e-5 (the
   JAX package's tau bar), the Harris-only instantiation picked for the
   flagship and the damped one for the others; reconstruct / chi2 /
   loglike('wrap') on CUDA each launch the tau kernel once; then the narrow
   flagship at B = 65,537 (over a grid dimension's 65,535 blocks, a
   partial last sample group), its first 100 and last 300 rows against
   plain;
5. timing, the card's name and power limit on every line: the fused kernel
   on the flagship and the narrow flagship, the tau kernel on both, at B=100
   and 200, and ``fwd.loglike_cube`` and ``fwd.reconstruct`` per call; the
   tau kernel and ``reconstruct`` again at B=1000, the size of a posterior.  A
   kernel's device time (``ms``) leaves the wrapper's host time out: 20
   calls captured back to back in a CUDA graph, the graph replayed between
   two CUDA events, the median of 10 replays over 20; its call time
   (``call_ms``, what the eager loop pays per batch) is the median of CUDA
   events around single calls; the plain version's is a call time; kernel
   and plain in turns (plain, kernel, kernel, plain).  Once, on the
   flagship at B=100, torch.profiler's kernel time cross-checks the graph
   method; one stacked launch of 4 x 100 flagship rows against four B=100
   launches, device and call time; the unit-cube entry beside the table
   entry at each fused timing (device, call and plain time, the bound of
   the same rows), and at 8 x 100 stacked flagship rows against the table
   entry alone and with its glue.  Prints the fused kernel's cluster and tile geometry and its
   resident CTAs per SM and clusters per card, and the tau kernel's sample
   groups, tiles and resident CTAs per SM at each batch (the CUDA occupancy
   API);
6. the slices: ``mcalf_torch.cli.main`` on a copy of testdata/fit.cfg at
   full width (ndim 34, nlive 200, B=100, canon_layout, the kernel on),
   depth cut by max_samples, then the same on the narrow flagship; checks
   the chain files, logZ, that every likelihood batch went through the
   fused kernel and that every slice iteration's bookkeeping went through
   the slice kernels (``slice_cuda.launches``, set to 0 just before the
   fit, = the loop's iterations);
7. the tau path: the narrow slice's equal-weight posterior through
   ``reconstruct``, ``chi2`` and a ``conv_mode='wrap'`` forward's
   ``loglike`` on the card, against the plain versions on the CPU;
8. statistical anchors: the 1-comp CIV fit with 3 seeds against the
   quadrature evidence of testdata/civ_mock_spec.txt, 4985.51, within 2x the
   mean logzerr; then with brange = 3, 40 (every evaluation in the full
   hjert) against 4985.30 = 4985.51 + ln(30/37) (the b prior's density
   changes from 1/30 to 1/37 where the posterior lies);
9. the runner's other fits through ``mcalf_torch.cli.main``, each a failure
   if it raises, if a file is missing or malformed, or if fewer fused-kernel
   launches than likelihood batches were counted (in a fleet: other than
   one launch per stacked likelihood call).  At full width (copies of
   testdata/fit.cfg as in phase 6): (a) ``seeds = 43,44``, one fleet,
   per-seed and merged files; (b) kill and resume: a run with ``[run] checkpoint`` to the
   end (42 outer steps: chunk boundaries at 8 and 40; 136 repeats, a quarter
   of phase 6's, to keep the script inside its time), the same run stopped
   by an exception from the chunk callback after its second checkpoint and
   started again from the files, ``.stats`` and ``_equal_weights.txt`` byte
   for byte the uninterrupted run's, then seed 43's checkpoint refused for
   seed 44.  At the 1-comp CIV anchor (ndim 4, nlive 200, to convergence):
   (c) ``solver = dypolychord`` with a ``[pc_settings]`` section (dynamic,
   implicit resume directory, ``_dead-birth.txt`` with base and boost rows),
   merged logZ within 2x its error, or 0.3, of 4985.51 and a posterior ESS
   above the base run's; (d) ``auto_repeats`` from ``num_repeats = 2``; (e)
   ``ncomp = 1, 2`` with ``ncomp_grid``; (f) two spectra, one fleet;
10. the fleet at full width: ``mcalf_torch.parallel.fit_many`` on 4 seeds
   (43-46) of phase 6's flagship slice, one fused launch per stacked
   likelihood call; seed 43's ``.stats`` and ``_equal_weights.txt``, written
   as the runner writes a fit's, byte for byte phase 6's; one
   ``slice_update`` launch per stacked slice iteration; the fleet's
   evals/s beside phase 6's;
11. the captured slice loop against the eager one on phase 6's slice and
   phase 10's fleet, in turns, then one profiled outer step of each (both
   loops run the slice kernels: phase 17 holds those to the torch ops);
12. the plot: ``mcalf_torch.cli.main`` with ``dofit = False``, ``doplot =
   True`` on phase 6's flagship chain files: exactly one ``voigt_tau``
   launch for the 100 posterior-draw overlays (B=100, T=22, P=1999), every
   value finite and within 1e-5 of the plain version on the CPU and of
   numpy's float64 ``reconstruct_spec``; the banner, and the NOTE where
   matplotlib is absent;
13. the HI forest: testdata/hi_forest.cfg at its shipped settings (nlive
   100, max_samples 8000, precision 0.05) with ``[run] seeds = 1,2,3,4``
   (one fleet) and its plot, to convergence: MAP ncomp 2 and the three
   absorbers within 0.5 A on every seed and the merge, one fused launch
   per stacked likelihood call, one ``voigt_tau`` launch for the plot, the
   mode table's instantiation printed, and the seeds' mean logZ within
   2 hypot(sd_jax / sqrt(16), sd / sqrt(4)) of the JAX package's mean
   (16 seeds measured on the CPU, stored below with its provenance);
14. the JAX package's last modules: (a) phase 6's flagship slice with
   ``[ns_settings] bracket = stepout`` through ``cli.main``, captured and
   with the eager loop: the chain files byte for byte the same, fused
   launches = likelihood calls run, evaluations and ms per iteration beside
   the chord's; (b) the step-out bracket's Gaussian battery (the JAX
   package's tests/test_sampler.py::test_stepout_bracket_evidence: ndim 4,
   6 seeds) on the card, mean logZ within 0.27 of 0; (c) ``python -m
   torch.distributed.run --standalone --nproc_per_node 2 -m mcalf_torch`` on
   phase 6's slice with ``[run] seeds = 43,44,45,46``, both ranks on this
   card over gloo, every chain file byte for byte a one-process
   ``cli.main`` run's, each rank's wall and fused launches; (d)
   ``ops.reference_style`` against the fused kernel at flagship B = 100 and
   200 (rtol 1e-5, atol 0.05, -inf pattern exact) and their call times;
15. stacked fleets outside ``'same_edge'`` and the calibration studies:
   (a) the tau kernel's problem axis on the flagship, the narrow flagship
   and the mixed model (each with its shorter-range twin padded to its
   pixels), B in {1, 13, 100, 1000} rows of the two problems interleaved
   at random, against the plain version at the tau bar and every row bit
   for bit the single-problem launch's, then one 2 x 200-row launch timed
   against a 400-row one; (b) ``fit_many`` of phase 10's four seeds with
   ``conv_mode='wrap'``, captured, then eager: members and chain files the
   same bytes, one ``voigt_tau`` launch per stacked likelihood call run and
   no fused launch; (c) tools/torch_truth_anchor.py with ``brange = 10,
   40`` and ``3, 40``: the quadrature logZ within 0.05 of the JAX
   package's on the same grid (taken on the CPU, stored below), the
   moments, and the fused kernel's device time at B = 16,384; (d)
   tools/torch_coverage_study.py at the JAX test's size (32 realizations,
   nlive 100, max_samples 6000) as one fleet, with its gates;
16. the JAX package's last public names, in a budget of 90 s: (a) the
   wing window switched off (``MCALF_TORCH_WINDOW=0``, the mode table
   ``[0] * 22``: plain Harris on every pixel, the counterpart of the
   plain-Harris branch of ``_ll_kernel`` and ``_tau_kernel``): the fused
   kernel against plain on the flagship at B in {100, 37, 1}, spread and
   z-clustered, at phase 3's bar, ``voigt_tau`` at B in {100, 1000} at
   the tau bar, log L with the switch off within 3e-6 relative of the
   switch on on 64 rows, and both kernels' device time in mode 0 against
   mode 1 at B = 100 and 200 (phase 5's method, in turns); (b) phase 6's
   flagship slice with the switch off through ``cli.main``: fused launches
   = likelihood calls run, logZ finite, evals/s beside phase 6's; (c)
   ``sampler.warmup_executables`` at the flagship's shapes with the
   library, geometry and mode-table caches emptied, then phase 6's slice
   through ``cli.main``: no library loaded and no geometry computed after
   the warm-up, the chain files byte for byte phase 6's; the warm-up's
   seconds, the build's and each graph capture's apart; (d)
   ``make_sampler`` byte for byte ``nested_sample`` on the flagship (seed
   43), and ``nested_sample_device`` on tests/test_torch_evidence_seeds.py's
   Gaussian, 8 seeds as one fleet, each member's logZ its solo run's, the
   mean within max(3 sem, 0.08) of 0; (e) each member of phase 15 (b)'s
   ``'wrap'`` fleet bit for bit its solo captured run;
17. the slice kernels (``sampler.nested._slice_step`` on the card: the
   ``slice_propose`` and ``slice_update`` launches around the likelihood
   call) against the torch ops that define them (``_slice_step_ops``) on
   the same carry, at the flagship's widths (ndim 34, B = 100, 816 passes)
   as one problem and as the 8-problem fleet, 16 iterations in a row
   with the loop reaching its cap: every carry tensor, ``n_like``,
   ``it_total``, the active-row counter and the rows handed to the
   likelihood bit for bit, the bracket ends by value (a zero end's sign
   reaches no proposal), on carries with NaN and sub-1e-12 direction
   entries, points on the cube's faces and log L at the constraint and
   -inf; then one iteration's bookkeeping timed both ways with a
   likelihood that launches nothing (device time by graph replay, call
   times) beside the bound of the bytes the kernels move.

Phase 5 also prints, at B=100, a census bound from the port's own FLOP
count of both plain versions (``mcalf_torch.utils.flops``, run on the CPU)
beside the branch-aware bound.

Then one JSON line with the kernels' launch counts, errors, device and
call times and bounds (at the narrow flagship, B=100; the tau kernel's at
every timed model and batch under ``by_batch``; the stacked launch under
``stacked``; mode 0 under ``mode0``; the unit-cube entry under ``cube``;
the slice kernels' at Q = 1 and 8 problems of 100 rows),
and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises.  The port
must not import jax or mcalf_tpu: checked at the end.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "testdata"
QUADRATURE_LOGZ = 4985.51  # 1-comp CIV on testdata/civ_mock_spec.txt
NARROW_LOGZ = QUADRATURE_LOGZ + math.log(30.0 / 37.0)  # brange 3, 40
SLICE_MAX_SAMPLES = 1000
SLICE_NUM_REPEATS = 544
#: phase 9's kill-and-resume run: 42 outer steps of 100 deletions, so that two
#: chunk boundaries (8 and 40 outer steps) lie before its end, at a quarter of
#: the slice's repeats (the boundaries are counted in steps, not evaluations)
RESUME_MAX_SAMPLES = 4200
RESUME_NUM_REPEATS = 136

#: the H100 SXM's published peaks (NVIDIA data sheet, at 700 W): float32
#: outside the tensor cores, and device memory
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    specres=[8.0], Nrange=[12.0, 14.5], zrange=[2.99, 3.01],
)
MODELS = {
    "flagship": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0]),
    "asymmlike": dict(_CIV, ncomp=(2, 4), nfill=1, brange=[10.0, 40.0],
                      Asymmlike=True),
    "narrow": dict(_CIV, ncomp=(8, 11), brange=[3.0, 40.0]),
    # the flagship's and the asymmlike model on a shorter range, padded to
    # 1999 pixels to stack with them
    "flagship_short": dict(_CIV, ncomp=(8, 11), brange=[10.0, 40.0],
                           fitrange=[(6182.0, 6216.0)]),
    "asymmlike_short": dict(_CIV, ncomp=(2, 4), nfill=1, brange=[10.0, 40.0],
                            Asymmlike=True, fitrange=[(6182.0, 6216.0)]),
    "narrow_short": dict(_CIV, ncomp=(8, 11), brange=[3.0, 40.0],
                         fitrange=[(6182.0, 6216.0)]),
    "mixed": dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3), nfill=1, specres=[8.0], Nrange=[12.0, 14.5],
        brange=[5.0, 40.0], zrange=[2.99, 3.01],
    ),
}
MODELS["mixed_short"] = dict(MODELS["mixed"], fitrange=[(6182.0, 6216.0)])


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


def phase_build() -> dict:
    from mcalf_torch.ops._build import load

    built = load()
    print(f"[2 build] {built.path.name} built in {built.build_seconds:.2f} s")
    regs = {}
    for name, line in ptxas_counts(built.log):
        print(f"[2 build] ptxas {name}: {line}")
        m = re.search(r"Used (\d+) registers", line)
        if m and name.startswith("fused_loglike_kernel"):
            regs[name] = int(m[1])
    print(f"[2 build] fused_loglike registers with the problem axis: {regs} "
          "(48 Harris-only and 80 damped before it)")
    return regs


def ptxas_counts(log: str):
    """(function, line) for ptxas's register and spill lines: each kernel's
    Harris-only and damped instantiation (the tau kernel's each with and
    without the problem axis, the fused kernel's each from tables and from
    the unit cube), the two slice kernels, and the device functions they
    call out of line."""
    name = "?"
    for ln in log.splitlines():
        if "entry function" in ln or "Function properties for" in ln:
            m = re.search(r"(voigt_tau_kernel|fused_loglike_kernel)ILb([01])E(?:Lb([01])E)?", ln)
            k = re.search(r"slice_(propose|update)_kernel", ln)
            if k:
                name = k[0]
            elif m:
                name = (f"{m[1]}<{'damped' if m[2] == '1' else 'harris'}"
                        f"{(', cube' if m[1].startswith('fused') else ', prob') if m[3] == '1' else ''}>")
            elif "wofz_real_916" in ln:
                name = "wofz_real_916"
            elif "free_taps" in ln:
                name = "free_taps"
        elif "registers" in ln or "spill" in ln:
            yield name, ln.strip().removeprefix("ptxas info    : ")


def _model(name):
    from mcalf_torch.models import AbsorptionModel

    return AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec_multicomp.txt"), **MODELS[name]
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


def _fused_args(fwd, u):
    from mcalf_torch.models import torch_model as tm

    s, c = fwd.static, fwd.consts()
    dz = (u[..., c["u_zidx"]] - 0.5) * c["zspan"]
    p = tm.cube_to_params_core(u, c)
    return p, tm.fused_args(p, c, s, dz=dz)


def _tau_args(fused_args):
    """voigt_tau's arguments out of fused_loglike's."""
    return fused_args[:6] + fused_args[11:]


def _kernel_and_plain(fwd, u):
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.ops import voigt_cuda

    s, c = fwd.static, fwd.consts()
    p, args = _fused_args(fwd, u)
    kw = dict(half=s.half, asymm=s.asymmlike)
    k = voigt_cuda.fused_loglike(*args, **kw)
    q = voigt_cuda.fused_loglike_plain(*args, **kw)
    return k, q, tm.loglike_from_fused(p, c, s, *k), tm.loglike_from_fused(p, c, s, *q)


def _check_cube(tag: str, u, prob, tables, s, table_ll) -> float:
    """The sampler's launch on unit-cube rows ``u`` against its plain twin
    on the same inputs (rtol 1e-5 / atol 0.05, the -inf pattern exact) and
    bit for bit ``table_ll``, the table entry's log L of the same rows
    through the glue.  Returns the largest |dlogL| against the twin."""
    from mcalf_torch.ops import voigt_cuda

    kw = dict(half=s.half, asymm=s.asymmlike)
    before = voigt_cuda.cube_launches
    got = voigt_cuda.fused_loglike_cube(u, prob, tables, **kw)
    plain = voigt_cuda.fused_loglike_cube_plain(u, prob, tables, **kw)
    torch.cuda.synchronize()
    if voigt_cuda.cube_launches != before + 1:
        raise AssertionError(f"{tag}: {voigt_cuda.cube_launches - before} cube launches")
    if not torch.equal(got, table_ll):
        raise AssertionError(f"{tag}: cube log L differs from the table entry's in "
                             f"{int((got != table_ll).sum())} of {got.numel()} rows")
    lc, lp = got.double().cpu().numpy(), plain.double().cpu().numpy()
    if not np.array_equal(np.isfinite(lc), np.isfinite(lp)):
        raise AssertionError(f"{tag}: cube -inf pattern differs from plain")
    fin = np.isfinite(lc)
    err = float(np.max(np.abs(lc[fin] - lp[fin]), initial=0.0))
    if not np.allclose(lc[fin], lp[fin], rtol=1e-5, atol=0.05):
        raise AssertionError(f"{tag}: cube max |dlogL| vs plain = {err}")
    return err


def phase_kernel_check() -> tuple:
    """Returns the largest |dlogL| of the table entry and of the cube
    entry against their plain versions."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models import torch_model as tm

    worst = worst_cube = 0.0
    for name in ("flagship", "asymmlike", "narrow", "mixed"):
        model = _model(name)
        fwd = make_torch_forward(model, "cuda")
        s = fwd.static
        tables = tm.cube_tables(fwd.consts(), s)
        modes = sorted(set(fwd.modes.tolist()))
        if modes != {"flagship": [1], "asymmlike": [1], "narrow": [2],
                     "mixed": [1, 2]}[name]:
            raise AssertionError(f"{name}: transition modes {modes}")
        for B in (100, 37, 1):
            for clustered in (False, True):
                u = _batch(s.ndim, B, clustered, seed=B + 7 * clustered,
                           layout=model.canon_layout())
                k, q, lk, lp = _kernel_and_plain(fwd, u)
                cube_err = _check_cube(f"{name} B={B}", u, None, tables, s, lk)
                worst_cube = max(worst_cube, cube_err)
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
                    f"modes {modes} B={B} "
                    f"{'z-clustered' if clustered else 'spread'}: "
                    f"max |dlogL| {err:.3g}, finite {int(fin.sum())}/{B}; cube entry: "
                    f"max |dlogL| vs plain {cube_err:.3g}, bit for bit the table entry's"
                )
    return worst, worst_cube


RAGGED_P = (1, 23, 255, 257, 2049, 5000)
#: the seeds of the flagship fleet whose stacked rows phases 3 and 5 check
#: and time (the benchmark's civ-flagship.seeds8)
FLEET_Q = 8
LONG_P = 65536  # over the shared-memory limit of one CTA per sample
BIG_B = 65537  # over CUDA's grid-dimension limit of 65,535 blocks


def _resampled(args, P, half, B, T=None):
    """fused_loglike's arguments for a spectrum of P pixels made from a
    model's (P0 pixels): its d0 rows, c/lambda, data, ivar and 1/noise
    linearly resampled onto P pixels, the first B samples and T transitions
    of its line tables; its own per-sample taps and continua when half is
    the model's, else one box of 2 half + 1 taps and one continuum shared by
    the batch (the kernel's stride-0 inputs)."""
    dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, modes = args
    T = T or dz.shape[1]
    x = np.linspace(0.0, cw.shape[0] - 1.0, P)
    grid = np.arange(cw.shape[0], dtype=np.float64)

    def resample(v):
        a = v.double().cpu().numpy()
        out = np.stack([np.interp(x, grid, row) for row in a.reshape(-1, a.shape[-1])])
        return torch.from_numpy(out.reshape(a.shape[:-1] + (P,)).astype(np.float32)).cuda()

    rows = lambda v: v[:B, :T].contiguous()
    if half == (kern.shape[1] - 1) // 2:
        kern, cont = kern[:B].contiguous(), cont[:B].contiguous()
    else:
        kern = torch.full((1, 2 * half + 1), 1.0 / (2 * half + 1), device=kern.device)
        cont = cont[:1].contiguous()
    return (rows(dz), rows(gain), rows(av), rows(dnu), resample(d0[:T]),
            resample(cw), resample(data), resample(ivar), resample(inv_noise),
            kern, cont, tmin[:T].contiguous(), modes[:T].contiguous())


def phase_ragged_check() -> float:
    """Ragged and long spectra against the plain version, and repeated
    launches bit-identical.  Returns the largest |dchi2|."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    worst = 0.0
    cases = [(P, half, None) for P in RAGGED_P for half in (0, 11) if P > 2 * half]
    cases.append((LONG_P, 11, 2))
    for name in ("flagship", "narrow"):
        fwd = make_torch_forward(_model(name), "cuda")
        s = fwd.static
        full = _fused_args(fwd, _batch(s.ndim, 100, False, seed=11, layout=None))[1]
        for P, half, T in cases:
            for B in (1, 100):
                args = _resampled(full, P, half, B, T)
                kw = dict(half=half, asymm=True)
                k = voigt_cuda.fused_loglike(*args, **kw)
                again = voigt_cuda.fused_loglike(*args, **kw)
                q = voigt_cuda.fused_loglike_plain(*args, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(k, again)):
                    raise AssertionError(f"{name} P={P} half={half} B={B}: "
                                         "two launches differ")
                ck, cq = k[0].double().cpu().numpy(), q[0].double().cpu().numpy()
                err = float(np.max(np.abs(ck - cq)))
                if not np.allclose(ck, cq, rtol=1e-5, atol=0.1):
                    raise AssertionError(f"{name} P={P} half={half} B={B}: "
                                         f"max |dchi2| = {err}")
                dn = max(float((a - b).abs().max()) for a, b in zip(k[1:], q[1:]))
                if dn > 1.0:
                    raise AssertionError(f"{name} P={P} half={half} B={B}: "
                                         f"n4/n5 differ by {dn}")
                worst = max(worst, err)
                g = voigt_cuda.fused_geometry(args[0].shape[1], P, half)
                print(
                    f"[3 ragged] {name} T={args[0].shape[1]} P={P} half={half} "
                    f"B={B}: cluster {g.cluster} x tile {g.tile}, max |dchi2| "
                    f"{err:.3g} (chi2 up to {float(cq.max()):.4g}), max |dn4/5| "
                    f"{dn:g}, repeat launch bit-identical"
                )
    # the production shape, repeated launches
    fwd = make_torch_forward(_model("flagship"), "cuda")
    args = _fused_args(fwd, _batch(fwd.static.ndim, 100, False, seed=5, layout=None))[1]
    kw = dict(half=fwd.static.half, asymm=True)
    first = voigt_cuda.fused_loglike(*args, **kw)
    for _ in range(5):
        if not all(torch.equal(a, b) for a, b in
                   zip(first, voigt_cuda.fused_loglike(*args, **kw))):
            raise AssertionError("flagship B=100: repeated launches differ")
    print("[3 ragged] flagship B=100: 6 launches bit-identical")
    return worst


def _stacked_pair(name):
    """The StackedForward of two different problems on the card: model
    ``name`` and the same model on a shorter fit range, padded to its
    pixels; and each problem's own TorchForward."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models.batched import pad_model_to_npix, stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward

    full = _model(name)
    models = [full, pad_model_to_npix(_model(name + "_short"), full.npix)]
    spec, stacked = stack_problems(models)
    return make_stacked_forward(spec, stacked, "cuda"), [make_torch_forward(m, "cuda") for m in models]


def _stacked_args(sf, u, prob):
    from mcalf_torch.models import torch_model as tm

    c = tm.row_consts(sf.consts(), prob)
    dz = (u[:, c["u_zidx"]] - 0.5) * c["zspan"]
    p = tm.cube_to_params_core(u, c)
    return p, c, tm.fused_args(p, c, sf.static, dz=dz, prob=prob)


def phase_stacked_check() -> tuple:
    """The kernel's problem axis: two problems' rows interleaved in one
    launch, against the plain version at the reference tolerance, and each
    row bit for bit the single-problem launch's; the cube entry on the same
    rows (:func:`_check_cube`); then the fleet's 8 x 100 flagship rows.
    Returns the largest |dlogL| of the table entry and of the cube entry."""
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.ops import voigt_cuda

    worst = worst_cube = 0.0
    for name in ("flagship", "asymmlike"):
        sf, solo = _stacked_pair(name)
        s = sf.static
        tables = tm.cube_tables(sf.consts(), s)
        for B in (100, 37, 1):
            u = _batch(s.ndim, 2 * B, False, seed=50 + B, layout=None)
            prob = torch.arange(2 * B, device="cuda", dtype=torch.int32) % 2
            p, c, args = _stacked_args(sf, u, prob)
            kw = dict(half=s.half, asymm=s.asymmlike, prob=prob)
            k = voigt_cuda.fused_loglike(*args, **kw)
            q = voigt_cuda.fused_loglike_plain(*args, **kw)
            lk = tm.loglike_from_fused(p, c, s, *k)
            cube_err = _check_cube(f"stacked {name} B={B}", u, prob, tables, s, lk)
            worst_cube = max(worst_cube, cube_err)
            lk = lk.double().cpu().numpy()
            lp = tm.loglike_from_fused(p, c, s, *q).double().cpu().numpy()
            torch.cuda.synchronize()
            if not np.array_equal(np.isfinite(lk), np.isfinite(lp)):
                raise AssertionError(f"stacked {name} B={B}: -inf pattern differs")
            fin = np.isfinite(lk)
            err = float(np.max(np.abs(lk[fin] - lp[fin]), initial=0.0))
            if not np.allclose(lk[fin], lp[fin], rtol=1e-5, atol=0.05):
                raise AssertionError(f"stacked {name} B={B}: max |dlogL| = {err}")
            if not np.allclose(k[0].double().cpu().numpy(), q[0].double().cpu().numpy(),
                               rtol=1e-5, atol=0.1):
                raise AssertionError(f"stacked {name} B={B}: chi2 differs from plain")
            for i in range(2):
                rows = prob == i
                one = voigt_cuda.fused_loglike(
                    *_fused_args(solo[i], u[rows])[1], half=s.half, asymm=s.asymmlike)
                if not all(torch.equal(a[rows], b) for a, b in zip(k, one)):
                    raise AssertionError(f"stacked {name} B={B}: problem {i}'s rows are not "
                                         "the single-problem launch's")
            worst = max(worst, err)
            print(f"[3 stacked] {name} + {name}_short padded, T={s.ntrans} P={s.npix}, "
                  f"2 x {B} rows interleaved in one launch: max |dlogL| vs plain {err:.3g}, "
                  f"finite {int(fin.sum())}/{2 * B}, every row bit for bit the "
                  f"single-problem launch's; cube entry: max |dlogL| vs plain {cube_err:.3g}, "
                  "bit for bit the table entry's")
    # the fleet's shape: 8 seeds of the flagship, 100 rows each, in one launch
    spec, stacked = stack_problems([_model("flagship")] * FLEET_Q)
    sf = tm.make_stacked_forward(spec, stacked, "cuda")
    u = _batch(spec.ndim, FLEET_Q * 100, False, seed=800, layout=None)
    prob = torch.arange(FLEET_Q, device="cuda", dtype=torch.int32).repeat_interleave(100)
    p, c, args = _stacked_args(sf, u, prob)
    lk = tm.loglike_from_fused(
        p, c, spec, *voigt_cuda.fused_loglike(*args, half=spec.half, asymm=spec.asymmlike,
                                              prob=prob))
    err = _check_cube(f"stacked flagship {FLEET_Q} x 100", u, prob,
                      tm.cube_tables(sf.consts(), spec), spec, lk)
    worst_cube = max(worst_cube, err)
    print(f"[3 stacked] flagship {FLEET_Q} x 100 rows (the fleet's launch): cube entry max "
          f"|dlogL| vs plain {err:.3g}, bit for bit the table entry's")
    return worst, worst_cube


def phase_tau_check() -> float:
    """Returns the largest |dtau| (the check is relative, see above)."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    worst = 0.0
    for name in ("flagship", "narrow", "mixed"):
        model = _model(name)
        fwd = make_torch_forward(model, "cuda")
        s = fwd.static
        damped = voigt_cuda._any_damped(fwd.modes)
        if damped != (name != "flagship"):
            raise AssertionError(f"tau {name}: the {'damped' if damped else 'Harris-only'} "
                                 "instantiation picked")
        for B in (100, 200, 13, 1000):
            u = _batch(s.ndim, B, B == 200, seed=3 * B, layout=model.canon_layout())
            args = _tau_args(_fused_args(fwd, u)[1])
            k = voigt_cuda.voigt_tau(*args)
            q = voigt_cuda.voigt_tau_plain(*args)
            torch.cuda.synchronize()
            err = float(((k - q).abs() / (q.abs() + 1e-3)).max())
            if not err < 3e-5:
                raise AssertionError(f"tau {name} B={B}: max rel err {err}")
            abs_err = float((k - q).abs().max())
            worst = max(worst, abs_err)
            g = voigt_cuda.tau_geometry(B, s.ntrans, s.npix, damped)
            print(
                f"[4 tau] {name} T={s.ntrans} P={s.npix} B={B} "
                f"({'damped' if damped else 'harris'}, S={g.samples}, {g.grid} CTAs of "
                f"{g.threads}): max |dtau|/(|tau|+1e-3) {err:.3g}, max |dtau| "
                f"{abs_err:.3g}, max tau {float(q.max()):.4g}"
            )
        # the entry points: one tau launch per call on the card
        p = _fused_args(fwd, _batch(s.ndim, 16, False, seed=1, layout=None))[0]
        wrap = make_torch_forward(model, "cuda", conv_mode="wrap")
        for what, fn in (("reconstruct", fwd.reconstruct), ("chi2", fwd.chi2),
                         ("loglike wrap", wrap.loglike)):
            before = voigt_cuda.tau_launches
            out = fn(p)
            torch.cuda.synchronize()
            if voigt_cuda.tau_launches != before + 1 or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {what}: tau launches "
                                     f"{voigt_cuda.tau_launches - before}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
        print(f"[4 tau] {name}: reconstruct, chi2, loglike(wrap) each launched "
              "voigt_tau once")
    # more samples than a grid dimension holds (65,535), the last group
    # partial: rows on both sides of 65,535 against the plain version
    fwd = make_torch_forward(_model("narrow"), "cuda")
    B = BIG_B
    args = _tau_args(_fused_args(fwd, _batch(fwd.static.ndim, B, False, seed=7, layout=None))[1])
    k = voigt_cuda.voigt_tau(*args)
    rows = torch.cat([torch.arange(0, 100), torch.arange(B - 300, B)]).cuda()
    q = voigt_cuda.voigt_tau_plain(*(a[rows] for a in args[:4]), *args[4:])
    torch.cuda.synchronize()
    err = float(((k[rows] - q).abs() / (q.abs() + 1e-3)).max())
    if not err < 3e-5:
        raise AssertionError(f"tau narrow B={B}: max rel err {err}")
    worst = max(worst, float((k[rows] - q).abs().max()))
    g = voigt_cuda.tau_geometry(B, fwd.static.ntrans, fwd.static.npix, True)
    print(f"[4 tau] narrow B={B} (S={g.samples}, {g.grid} CTAs, last group of "
          f"{B - (g.grid // g.ntiles - 1) * g.samples}): rows 0-99 and {B - 300}-{B - 1} "
          f"against plain, max |dtau|/(|tau|+1e-3) {err:.3g}")
    return worst


def _median_ms(fn, reps=30):
    """Call time: the median of CUDA events recorded around single calls on
    an idle stream, so the wrapper's host time before the launch is in it."""
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


def _device_ms(fn, n=20, reps=10):
    """Device time of one call, without the host's: n calls captured back to
    back in a CUDA graph (each wrapper launches on the current stream, the
    capture stream), the graph replayed between two CUDA events; the median
    over reps replays, divided by n."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _profiled_ms(fn, kernel: str, n=20):
    """torch.profiler's mean device time of the kernels whose name holds
    `kernel` over n calls, or None when the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += float(getattr(evt, "self_device_time_total", 0.0)
                              or getattr(evt, "self_cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None


# Operations per (sample, transition, pixel) pair by the branch it takes,
# counted from csrc/voigt_h.cuh (a fused multiply-add counts 2, every other
# arithmetic operation, division or transcendental 1; compares and selects
# 0).  Each count includes forming u (3) and adding into tau (2).
_OPS_HARRIS = {1: 39, 2: 40, 3: 35, 4: 30}  # by Dawson region of t = u^2
_OPS_WING = 23
_OPS_916 = 246
_OPS_ASYM = 43
#: per (sample, transition) in mode 2: the 27 series denominators, sigma1
#: and erfcx; per (sample, transition) in any mode: 1/dnu
_OPS_DAMPED_LINE = 180


def _tau_ops(args) -> float:
    """Operations the tau synthesis needs on these inputs: each (sample,
    transition, pixel) pair counted by the branch the kernels take for it."""
    dz, gain, av, dnu, d0, cw, tmin, modes = args
    B, T = dz.shape
    ops = float(B * T)
    for t, (mode, tm) in enumerate(zip(modes.tolist(), tmin.tolist())):
        u = (d0[t].double() + dz[:, t : t + 1].double() * cw.double()).float()
        u = u / dnu[:, t : t + 1]
        u2 = u * u
        if mode == 2:
            near = int((u2 + av[:, t : t + 1] ** 2 < 111.0).sum())
            ops += near * _OPS_916 + (u2.numel() - near) * _OPS_ASYM
            ops += B * _OPS_DAMPED_LINE
            continue
        harris = u2 < tm if mode == 1 else torch.ones_like(u2, dtype=torch.bool)
        ops += int((~harris).sum()) * _OPS_WING
        edges = (2.25, 6.25, 16.0, math.inf)
        lo = -1.0
        for region, hi in enumerate(edges, start=1):
            ops += int((harris & (u2 > lo) & (u2 <= hi)).sum()) * _OPS_HARRIS[region]
            lo = hi
    return ops


def _bound(args, fused: bool, half: int = 0, prob=None, ops=None):
    """(bound ms, 'bytes' or 'operations'): the larger of the bytes the
    call must move over the memory rate and its operations over the
    float32 rate.  The operations are counted per branch taken unless
    ``ops`` gives them (a census).  With ``prob`` (a stacked launch) each
    problem's rows count against its own tables."""
    dz, _, _, _, d0, cw = args[:6]
    B, T = dz.shape
    P = cw.shape[-1]
    K = 2 * half + 1
    if ops is None:
        targs = _tau_args(args) if fused else args
        if prob is None:
            ops = _tau_ops(targs)
        else:
            ops = 0.0
            for q in range(d0.shape[0]):
                rows = prob == q
                ops += _tau_ops(tuple(a[rows] for a in targs[:4]) + (d0[q], cw[q]) + targs[6:])
        if fused:
            ops += B * (P + 2 * K * max(P - 2 * half, 0) + 4 * P)  # exp, LSF, chi^2
    nbytes = 4 * (4 * B * T + d0.numel() + cw.numel() + 2 * T) + (0 if prob is None else 4 * B)
    if fused:
        data, ivar, inv_noise, kern, cont = args[6:11]
        nbytes += 4 * (data.numel() + ivar.numel() + inv_noise.numel() + kern.numel()
                       + cont.numel() + 3 * B)
    else:
        nbytes += 4 * B * P
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _census(args, fused: bool, half: int = 0) -> int:
    """FLOP of the plain version on CPU copies of ``args``, by the port's
    own census (mcalf_torch/utils/flops.py): every op the plain code runs
    (both sides of each select; a windowed transition's Harris expansion
    only on the pixels inside its window)."""
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.utils.flops import flop_census

    cpu = [a.cpu() for a in args]
    if fused:
        return flop_census(lambda: voigt_cuda.fused_loglike_plain(*cpu, half=half, asymm=False)).flops
    return flop_census(lambda: voigt_cuda.voigt_tau_plain(*cpu)).flops


def phase_timing(smi: str) -> dict:
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.ops import voigt_cuda

    out = {}
    for name in ("flagship", "narrow"):
        fwd = make_torch_forward(_model(name), "cuda")
        s = fwd.static
        tables = tm.cube_tables(fwd.consts(), s)
        g = voigt_cuda.fused_geometry(s.ntrans, s.npix, s.half)
        damped = voigt_cuda.MODE_HJERT in fwd.modes.tolist()
        ctas_per_sm, clusters = voigt_cuda.fused_occupancy(s.ntrans, s.npix, s.half, damped)
        print(
            f"[5 timing] {name} fused geometry: T={s.ntrans} P={s.npix} half={s.half} "
            f"({'damped' if damped else 'harris'} kernel): "
            f"cluster {g.cluster} x tile {g.tile} pixels, {g.threads} threads and "
            f"{g.smem} B of shared memory per CTA; {ctas_per_sm} CTAs "
            f"({ctas_per_sm * g.threads // 32} warps) resident per SM, {clusters} "
            f"clusters ({clusters * g.cluster} CTAs) per card; CTAs launched: "
            f"{100 * g.cluster} at B=100, {200 * g.cluster} at B=200"
        )
        for B in (100, 200):
            u = _batch(s.ndim, B, False, seed=B, layout=None)
            p, args = _fused_args(fwd, u)
            targs = _tau_args(args)
            kw = dict(half=s.half, asymm=False)
            fused = lambda: voigt_cuda.fused_loglike(*args, **kw)
            fused_plain = lambda: voigt_cuda.fused_loglike_plain(*args, **kw)
            tau = lambda: voigt_cuda.voigt_tau(*targs)
            tau_plain = lambda: voigt_cuda.voigt_tau_plain(*targs)
            # kernel and plain in turns: plain, kernel, kernel, plain
            fp = [_median_ms(fused_plain, reps=10)]
            fk = [_device_ms(fused), _device_ms(fused)]
            fc = _median_ms(fused)
            fp.append(_median_ms(fused_plain, reps=10))
            tp = [_median_ms(tau_plain, reps=10)]
            tk = [_device_ms(tau), _device_ms(tau)]
            tc = _median_ms(tau)
            tp.append(_median_ms(tau_plain, reps=10))
            # the sampler's launch on the same rows as unit-cube points
            ckw = dict(half=s.half, asymm=s.asymmlike)
            cube = lambda: voigt_cuda.fused_loglike_cube(u, None, tables, **ckw)
            cube_plain = lambda: voigt_cuda.fused_loglike_cube_plain(u, None, tables, **ckw)
            cp = [_median_ms(cube_plain, reps=5)]
            ck = [_device_ms(cube), _device_ms(cube)]
            cc = _median_ms(cube)
            cp.append(_median_ms(cube_plain, reps=5))
            ms_cube = _median_ms(lambda: fwd.loglike_cube(u))
            ms_rec = _median_ms(lambda: fwd.reconstruct(p))
            fb, fby = _bound(args, True, s.half)
            tb, tby = _bound(targs, False)
            rec = dict(
                fused=(float(np.mean(fk)), fc, float(np.mean(fp)), fb, fby),
                tau=(float(np.mean(tk)), tc, float(np.mean(tp)), tb, tby),
                cube=(float(np.mean(ck)), cc, float(np.mean(cp)), fb, fby),
            )
            out[name, B] = rec
            print(
                f"[5 timing] {name} B={B}: fused kernel device {fk[0]:.4f}/{fk[1]:.4f} ms "
                f"({rec['fused'][0] * 1e3 / B:.4f} us/eval), call {fc:.4f} ms, plain "
                f"{fp[0]:.2f}/{fp[1]:.2f} ms, bound {fb:.4f} ms ({fby}); "
                f"voigt_tau device {tk[0]:.4f}/{tk[1]:.4f} ms, call {tc:.4f} ms, plain "
                f"{tp[0]:.2f}/{tp[1]:.2f} ms, bound {tb:.4f} ms ({tby}); loglike_cube "
                f"{ms_cube:.4f} ms/call, reconstruct {ms_rec:.4f} ms/call  [{smi}]"
            )
            print(
                f"[5 timing] {name} B={B}: cube entry device {ck[0]:.4f}/{ck[1]:.4f} ms "
                f"(table entry {fk[0]:.4f}/{fk[1]:.4f}), call {cc:.4f} ms (table {fc:.4f}), "
                f"plain {cp[0]:.2f}/{cp[1]:.2f} ms, bound of the same rows {fb:.4f} ms "
                f"({fby})  [{smi}]"
            )
            if B == 100:
                t0 = time.perf_counter()
                cf, ct = _census(args, True, s.half), _census(targs, False)
                cb, cby = _bound(args, True, s.half, ops=cf)
                ctb, ctby = _bound(targs, False, ops=ct)
                rec["census"] = dict(fused=(cf, cb, cby), tau=(ct, ctb, ctby))
                per = B * s.ntrans * s.npix
                print(
                    f"[5 timing] {name} B=100 census bound (mcalf_torch.utils.flops on the plain "
                    f"versions, on the CPU, {time.perf_counter() - t0:.1f} s): fused {cf} FLOP "
                    f"({cf / per:.2f} per sample, transition and pixel), bound {cb:.4f} ms ({cby}) "
                    f"against the branch-aware {fb:.4f} ms; voigt_tau {ct} FLOP ({ct / per:.2f}), "
                    f"bound {ctb:.4f} ms ({ctby}) against {tb:.4f} ms  [{smi}]"
                )
            if name == "flagship" and B == 100:
                pf = _profiled_ms(fused, "fused_loglike_kernel")
                pt = _profiled_ms(tau, "voigt_tau_kernel")
                show = lambda v: "no device time in the trace" if v is None else f"{v:.4f} ms"
                print(f"[5 timing] flagship B=100 torch.profiler kernel time: fused "
                      f"{show(pf)}, voigt_tau {show(pt)} (graph method "
                      f"{rec['fused'][0]:.4f}, {rec['tau'][0]:.4f} ms)  [{smi}]")
                rec["profiled"] = (pf, pt)
        # the tau kernel's posterior batch (about 10^3 equal-weight rows)
        u = _batch(s.ndim, 1000, False, seed=1000, layout=None)
        p, args = _fused_args(fwd, u)
        targs = _tau_args(args)
        tau = lambda: voigt_cuda.voigt_tau(*targs)
        tk = [_device_ms(tau), _device_ms(tau)]
        tc = _median_ms(tau)
        ms_rec = _median_ms(lambda: fwd.reconstruct(p))
        tb, tby = _bound(targs, False)
        out[name, 1000] = dict(tau=(float(np.mean(tk)), tc, None, tb, tby))
        print(
            f"[5 timing] {name} B=1000: voigt_tau device {tk[0]:.4f}/{tk[1]:.4f} ms, call "
            f"{tc:.4f} ms, bound {tb:.4f} ms ({tby}); reconstruct {ms_rec:.4f} ms/call  [{smi}]"
        )
        for B in (100, 200, 1000):
            g = voigt_cuda.tau_geometry(B, s.ntrans, s.npix, damped)
            ctas = voigt_cuda.tau_occupancy(damped, g)
            print(
                f"[5 timing] {name} tau geometry B={B} ({'damped' if damped else 'harris'} "
                f"kernel): groups of S={g.samples} samples x tiles of {g.tile} pixels, "
                f"{g.grid} CTAs of {g.threads} threads, {g.smem} B of shared memory each; "
                f"{ctas} CTAs ({ctas * g.threads // 32} warps) resident per SM"
            )
    out["stacked"] = _time_stacked(smi)
    out["fleet_cube"] = _time_fleet_cube(smi)
    return out


def _time_stacked(smi: str) -> dict:
    """One launch of 4 x 100 flagship rows (four stacked problems, a
    fleet's batch) against the four B=100 launches of the problems alone,
    in turns."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward
    from mcalf_torch.ops import voigt_cuda

    model = _model("flagship")
    spec, stacked = stack_problems([model] * 4)
    sf = make_stacked_forward(spec, stacked, "cuda")
    fwd = make_torch_forward(model, "cuda")
    u = _batch(spec.ndim, 400, False, seed=400, layout=None)
    prob = torch.arange(4, device="cuda", dtype=torch.int32).repeat_interleave(100)
    args = _stacked_args(sf, u, prob)[2]
    singles = [_fused_args(fwd, u[100 * q:100 * (q + 1)])[1] for q in range(4)]
    kw = dict(half=spec.half, asymm=False)
    one = lambda: voigt_cuda.fused_loglike(*args, **kw, prob=prob)
    four = lambda: [voigt_cuda.fused_loglike(*a, **kw) for a in singles]
    plain = lambda: voigt_cuda.fused_loglike_plain(*args, **kw, prob=prob)
    dev = [_device_ms(four), _device_ms(one), _device_ms(one), _device_ms(four)]
    call = [_median_ms(four), _median_ms(one), _median_ms(one), _median_ms(four)]
    plain_ms = _median_ms(plain, reps=5)
    bound, by = _bound(args, True, spec.half, prob=prob)
    rec = dict(rows=400, ms=(dev[1] + dev[2]) / 2, call_ms=(call[1] + call[2]) / 2,
               four_launches_ms=(dev[0] + dev[3]) / 2, four_calls_ms=(call[0] + call[3]) / 2,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    print(
        f"[5 timing] stacked flagship 4 x 100 rows: one launch device {dev[1]:.4f}/{dev[2]:.4f} "
        f"ms, call {call[1]:.4f}/{call[2]:.4f} ms; four B=100 launches device "
        f"{dev[0]:.4f}/{dev[3]:.4f} ms, calls {call[0]:.4f}/{call[3]:.4f} ms; plain "
        f"{plain_ms:.2f} ms; bound {bound:.4f} ms ({by})  [{smi}]"
    )
    return rec


def _time_fleet_cube(smi: str) -> dict:
    """The fleet's launch, 8 x 100 stacked flagship rows: the cube entry
    (the sampler's whole likelihood call) against the table entry alone and
    with the glue that makes its tables (the call before the cube entry), in
    turns; the bound of the same rows."""
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.ops import voigt_cuda

    spec, stacked = stack_problems([_model("flagship")] * FLEET_Q)
    sf = tm.make_stacked_forward(spec, stacked, "cuda")
    u = _batch(spec.ndim, FLEET_Q * 100, False, seed=801, layout=None)
    prob = torch.arange(FLEET_Q, device="cuda", dtype=torch.int32).repeat_interleave(100)
    tables = tm.cube_tables(sf.consts(), spec)
    args = _stacked_args(sf, u, prob)[2]
    kw = dict(half=spec.half, asymm=spec.asymmlike)

    def with_glue():
        p, c, a = _stacked_args(sf, u, prob)
        return tm.loglike_from_fused(p, c, spec, *voigt_cuda.fused_loglike(*a, **kw, prob=prob))

    fns = dict(cube=lambda: voigt_cuda.fused_loglike_cube(u, prob, tables, **kw),
               table=lambda: voigt_cuda.fused_loglike(*args, **kw, prob=prob),
               table_with_glue=with_glue)
    order = ("table_with_glue", "cube", "table", "table", "cube", "table_with_glue")
    dev, call = collections.defaultdict(list), collections.defaultdict(list)
    for k in order:
        dev[k].append(_device_ms(fns[k]))
    for k in order:
        call[k].append(_median_ms(fns[k]))
    plain_ms = _median_ms(lambda: voigt_cuda.fused_loglike_cube_plain(u, prob, tables, **kw),
                          reps=5)
    bound, by = _bound(args, True, spec.half, prob=prob)
    rec = dict(rows=FLEET_Q * 100, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    for k in fns:
        rec[f"{k}_ms"] = float(np.mean(dev[k]))
        rec[f"{k}_call_ms"] = float(np.mean(call[k]))
    print(
        f"[5 timing] stacked flagship {FLEET_Q} x 100 rows (the fleet's launch): device "
        + ", ".join(f"{k} {'/'.join(f'{v:.4f}' for v in dev[k])} ms" for k in fns)
        + "; call " + ", ".join(f"{k} {'/'.join(f'{v:.4f}' for v in call[k])} ms" for k in fns)
        + f"; cube plain {plain_ms:.2f} ms; bound {bound:.4f} ms ({by})  [{smi}]"
    )
    return rec


def _cube_entry(timing: dict, worst: float, worst_stacked: float) -> dict:
    """The ``kernels`` line's record of the unit-cube entry, in the table
    entry's terms: device, call and plain ms and the bound of the same rows
    at the narrow flagship B=100 (each timed model and batch under
    ``by_batch``), the errors against its plain twin, and the fleet's
    8 x 100-row launch."""
    names = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    return dict(
        zip(names, timing["narrow", 100]["cube"]),
        max_abs_err=worst, max_abs_err_stacked=worst_stacked,
        by_batch={f"{m} B={B}": dict(zip(names, timing[m, B]["cube"]))
                  for m in ("flagship", "narrow") for B in (100, 200)},
        stacked=timing["fleet_cube"],
    )


def _write_cfg(path: Path, outdir: Path, brange=None, run="",
               max_samples=SLICE_MAX_SAMPLES, num_repeats=SLICE_NUM_REPEATS, ns="") -> None:
    """A copy of testdata/fit.cfg that writes under ``outdir``, its depth cut
    by ``max_samples``; ``run`` and ``ns`` hold further lines of its [run]
    and [ns_settings] sections."""
    text = (TESTDATA / "fit.cfg").read_text()
    text = text.replace("datadir = testdata/", f"datadir = {TESTDATA}/")
    text = text.replace("outdir = testdata/output/", f"outdir = {outdir}/")
    text = text.replace("doplot = True", "doplot = False\n" + run)
    if brange is not None:
        text = text.replace("brange = 10.0, 40.0", f"brange = {brange}")
    text += (
        "\n[ns_settings]\n"
        f"max_samples = {max_samples}\n"
        f"num_repeats = {num_repeats}\n"
        + ns
    )
    path.write_text(text)


def _drive_cli(cfg: Path, *argv) -> dict:
    """``mcalf_torch.cli.main`` on ``cfg`` with the fused kernel's launch
    count and the captured loops' counts set to 0 just before and read just
    after.  Beside it: what every ``runner.run_fit`` and
    ``runner.dynamic_sample`` call returned, the likelihood batches the card
    ran (calls of ``TorchForward.loglike_cube``), the stacked likelihood
    calls of a fleet (``StackedForward.loglike_cube``) and their rows.  A
    call counts when the card runs it (``utils.profiling.count_launch``): a
    call captured in the slice loop's CUDA graph counts at each replay; so
    does a ``slice_update`` launch (``slice_cuda.launches``, set to 0 just
    before too).  An exception of the fit passes through, the counts up to
    it in its ``drive`` attribute."""
    from mcalf_torch import cli, runner
    from mcalf_torch.models.torch_model import StackedForward, TorchForward
    from mcalf_torch.ops import slice_cuda, voigt_cuda
    from mcalf_torch.sampler import graph
    from mcalf_torch.utils.profiling import count_launch

    out = {"fits": [], "dynamic": [], "batches": 0, "rows": 0, "stacked": 0}
    run_fit, dynamic_sample = runner.run_fit, runner.dynamic_sample
    loglike_cube = TorchForward.loglike_cube
    stacked_loglike_cube = StackedForward.loglike_cube

    def recording(fn, into):
        def wrapped(*a, **k):
            into.append(fn(*a, **k))
            return into[-1]

        return wrapped

    def count(kind, rows):
        def add(n):
            out[kind] += n
            out["rows"] += n * rows

        count_launch(add)

    def counted_loglike_cube(self, u):
        count("batches", u.shape[:-1].numel())
        return loglike_cube(self, u)

    def counted_stacked(self, u, prob):
        count("stacked", u.shape[0])
        return stacked_loglike_cube(self, u, prob)

    runner.run_fit = recording(run_fit, out["fits"])
    runner.dynamic_sample = recording(dynamic_sample, out["dynamic"])
    TorchForward.loglike_cube = counted_loglike_cube
    StackedForward.loglike_cube = counted_stacked
    try:
        voigt_cuda.launches = 0
        slice_cuda.launches = 0
        graph.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out["rc"] = cli.main([str(cfg), *argv])
        except Exception as e:
            e.drive = out
            raise
        finally:
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
            out["launches"] = voigt_cuda.launches
            out["slice_launches"] = slice_cuda.launches
            out["graph"] = dict(graph.stats)
    finally:
        runner.run_fit, runner.dynamic_sample = run_fit, dynamic_sample
        TorchForward.loglike_cube = loglike_cube
        StackedForward.loglike_cube = stacked_loglike_cube
    return out


def _read_chain_pair(base: str, ncols: int):
    """(logZ, error, rows) of a `.stats` + `_equal_weights.txt` pair, read
    through the port's analysis module; raises on a malformed file."""
    from mcalf_torch.analysis import analyze_chains

    logz, err, lhood, post = analyze_chains(base, return_sorted=False)
    if not (math.isfinite(logz) and math.isfinite(err) and err >= 0):
        raise AssertionError(f"bad {base}.stats: logZ {logz} +/- {err}")
    if post.shape[1] != ncols - 2 or len(post) == 0 or not (
        np.all(np.isfinite(post)) and np.all(np.isfinite(lhood))
    ):
        raise AssertionError(f"bad {base}_equal_weights.txt: shape {post.shape}")
    return logz, err, post


def phase_slice(tmp: Path, name: str, brange=None) -> dict:
    out = tmp / name
    out.mkdir()
    cfg = out / "fit.cfg"
    _write_cfg(cfg, out, brange)
    run = _drive_cli(cfg)
    launches, wall = run["launches"], run["wall"]
    if run["rc"] != 0 or len(run["fits"]) != 1:
        raise AssertionError(f"cli.main returned {run['rc']}, fits run: {len(run['fits'])}")
    res, base = run["fits"][0]
    logz, _, posterior = _read_chain_pair(base, 2 + 34)
    nlive, B = 200, 100
    batches = 1 + (res.n_like - nlive) // B  # calls with a chain to move
    g = run["graph"]
    if launches < run["batches"] or launches < batches or g["captures"] != 1:
        raise AssertionError(f"{launches} kernel launches, {run['batches']} batches run, "
                             f"{batches} with a chain to move, {g['captures']} graphs")
    slices, iterations = run["slice_launches"], g["warmups"] + g["iterations"]
    if slices != iterations:
        raise AssertionError(f"{name}: {slices} slice_update launches for {iterations} slice "
                             "iterations run (the chord bracket on the card takes the kernels)")
    print(
        f"[6 slice] {name} ndim=34 nlive=200 B=100 num_repeats="
        f"{SLICE_NUM_REPEATS} max_samples={SLICE_MAX_SAMPLES}: "
        f"{res.n_iter} steps, n_like={res.n_like}, wall {wall:.2f} s, "
        f"{res.n_like / wall:.4g} evals/s, logZ={logz:.3f} "
        f"(+/- {float(res.logzerr):.3f}, unconverged by design), "
        f"kernel launches {launches} >= batches run {run['batches']} (1 initial + "
        f"{g['warmups']} warm-up + "
        f"{g['replays']} replays x {g['iterations'] // max(g['replays'], 1)}) >= "
        f"{batches} with a chain to move; {g['replays'] / res.n_iter:.2f} replays and "
        f"{g['reads'] / res.n_iter:.2f} flag reads per outer step; "
        f"{wall / (launches - 1) * 1e3:.4f} ms per slice iteration run; "
        f"slice_update launches {slices} = slice iterations run; "
        f"equal-weight rows {posterior.shape[0]}"
    )
    return {"launches": launches, "slice_launches": slices, "wall": wall, "n_like": res.n_like,
            "posterior": posterior, "base": base, "iterations": launches - 1,
            "graph": g, "steps": res.n_iter}


def phase_tau_path(posterior: np.ndarray) -> dict:
    """The model-evaluation entry points on the narrow slice's posterior:
    the user's model flux, chi^2 and 'wrap' likelihood, as plotting and
    model checks call them."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    model = _model("narrow")
    fwd = make_torch_forward(model)
    wrap = make_torch_forward(model, conv_mode="wrap")
    p = torch.from_numpy(posterior.astype(np.float32)).cuda()
    voigt_cuda.tau_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = fwd.reconstruct(p)
    chi2 = fwd.chi2(p)
    ll = wrap.loglike(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = voigt_cuda.tau_launches
    if launches < 3:
        raise AssertionError(f"tau path: {launches} voigt_tau launches < 3 calls")
    for what, x, shape in (("flux", flux, (len(p), model.npix)),
                           ("chi2", chi2, (len(p),)), ("loglike", ll, (len(p),))):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"tau path {what}: shape {tuple(x.shape)}, "
                                 f"finite {bool(torch.isfinite(x).all())}")
    # against the plain versions on the CPU, on a few rows
    cpu, cwrap = make_torch_forward(model, "cpu"), make_torch_forward(model, "cpu", conv_mode="wrap")
    pc = p[:16].cpu()
    dflux = float((flux[:16].cpu() - cpu.reconstruct(pc)).abs().max())
    if not dflux < 1e-5:
        raise AssertionError(f"tau path: max |dflux| {dflux} vs the CPU")
    for what, got, want, atol in (("chi2", chi2[:16], cpu.chi2(pc), 0.1),
                                  ("loglike", ll[:16], cwrap.loglike(pc), 0.05)):
        if not np.allclose(got.double().cpu().numpy(), want.double().numpy(), rtol=1e-5, atol=atol):
            raise AssertionError(f"tau path {what} differs from the CPU")
    g = voigt_cuda.tau_geometry(len(p), fwd.static.ntrans, fwd.static.npix, True)
    print(
        f"[7 tau path] narrow posterior rows {len(p)}: reconstruct, chi2, "
        f"loglike(wrap) in {wall * 1e3:.2f} ms, voigt_tau launches {launches} "
        f"(groups of S={g.samples}, {g.grid} CTAs each); max |dflux| vs CPU plain "
        f"{dflux:.3g}, min chi2 {float(chi2.min()):.2f}"
    )
    return {"launches": launches}


def phase_anchor(brange, want: float, tag: str) -> None:
    from mcalf_torch.models import AbsorptionModel, make_torch_forward
    from mcalf_torch.sampler import NSConfig, insertion_rank_test, nested_sample

    model = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), **dict(_CIV, ncomp=(1, 1), brange=brange),
    )
    fwd = make_torch_forward(model, "cuda")
    modes = sorted(set(fwd.modes.tolist()))
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
            f"[8 anchor] {tag} modes {modes} seed {seed}: logZ {res.logz:.3f} "
            f"+/- {res.logzerr:.3f}, rank p {p:.4f}, n_like {res.n_like}, "
            f"{res.n_iter} steps, converged={res.termination_reason == 0}, "
            f"wall {wall:.2f} s"
        )
    mean, merr = float(np.mean(logz)), float(np.mean(err))
    ok = abs(mean - want) < 2.0 * merr
    print(
        f"[8 anchor] {tag} mean logZ {mean:.3f} vs {want:.2f}: "
        f"|d| {abs(mean - want):.3f} < 2 x mean logzerr {2 * merr:.3f}: {ok}"
    )
    if not ok:
        raise AssertionError(f"{tag} anchor outside 2x mean logzerr")


ANCHOR_CFG = """
[input]
specfile = {specfile}
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = {solver}
specres = 8.0

[pathing]
datadir = {testdata}/
outdir = {out}/
chainfmt = pc_fits_{{0}}

[components]
ncomp = {ncomp}
contval = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
{run}

{sections}
"""
ANCHOR_NLIVE = 200
ANCHOR_MAX_SAMPLES = 12000


def _anchor_cfg(out: Path, *, solver="polychord", ncomp="1,1", run="", ns="",
                pc_settings=False, specfile="civ_mock_spec.txt") -> Path:
    """The 1-comp CIV anchor of phase 8 (ndim 4, nlive 200, max_samples
    12000) as a config file that writes under ``out``; nlive in a
    ``[pc_settings]`` section when asked, ``ns`` further ``[ns_settings]``
    lines."""
    nlive = f"nlive = {ANCHOR_NLIVE}\n"
    sections = (
        ("[pc_settings]\n" + nlive + "\n[ns_settings]\n" if pc_settings
         else "[ns_settings]\n" + nlive)
        + f"max_samples = {ANCHOR_MAX_SAMPLES}\n" + ns
    )
    out.mkdir()
    cfg = out / "fit.cfg"
    cfg.write_text(ANCHOR_CFG.format(
        specfile=specfile, solver=solver, testdata=TESTDATA, out=out, ncomp=ncomp,
        run=run, sections=sections,
    ))
    return cfg


def _check_launches(tag: str, run: dict) -> None:
    """A solo fit: at least one fused launch per likelihood batch run.  A
    fleet (stacked calls, no solo batch): exactly one per stacked call run
    (replayed iterations included)."""
    if run.get("rc", 0) != 0:
        raise AssertionError(f"{tag}: cli.main returned {run['rc']}")
    if run["stacked"]:
        if run["batches"] != 0 or run["launches"] != run["stacked"]:
            raise AssertionError(f"{tag}: {run['launches']} fused-kernel launches for "
                                 f"{run['stacked']} stacked likelihood calls and "
                                 f"{run['batches']} solo batches")
    elif run["batches"] == 0 or run["launches"] < run["batches"]:
        raise AssertionError(f"{tag}: {run['launches']} fused-kernel launches < "
                             f"{run['batches']} likelihood batches")


def _near_quadrature(tag: str, logz: float, err: float) -> str:
    tol = max(2.0 * err, 0.3)
    if not abs(logz - QUADRATURE_LOGZ) < tol:
        raise AssertionError(f"{tag}: merged logZ {logz:.3f} +/- {err:.3f} is not within "
                             f"{tol:.3f} of {QUADRATURE_LOGZ}")
    return f"|logZ - {QUADRATURE_LOGZ}| {abs(logz - QUADRATURE_LOGZ):.3f} < {tol:.3f}"


def _stats_lines(base: str):
    return Path(base + ".stats").read_text().splitlines()


def _deadbirth_logz(dead: np.ndarray) -> float:
    """The evidence of a `_dead-birth.txt` from its (logL, birth logL) pairs
    alone, the live count at each death recovered from the birth contours
    (anesthetic's reconstruction)."""
    order = np.argsort(dead[:, -2], kind="stable")
    logl, birth = dead[order, -2], dead[order, -1]
    born = np.searchsorted(np.sort(birth), logl, side="left")
    nlive = np.maximum(born - np.searchsorted(logl, logl, side="left"), 1).astype(np.float64)
    logx = np.cumsum(np.log(nlive) - np.log(nlive + 1.0))
    a = np.concatenate([[0.0], logx[:-1]]) - np.log(nlive + 1.0) + logl
    return float(a.max() + np.log(np.sum(np.exp(a - a.max()))))


def phase_variants(tmp: Path, smi: str) -> int:
    """Phase 9: the runner's other fits through the CLI.  Returns the fused
    kernel's launches over all of them."""
    from mcalf_torch import runner
    from mcalf_torch.sampler import posterior_ess

    total = 0

    def report(tag, run, text):
        nonlocal total
        _check_launches(tag, run)
        total += run["launches"]
        if run["stacked"]:
            launches = (f"fused-kernel launches {run['launches']} = stacked likelihood "
                        f"calls run {run['stacked']}")
        else:
            launches = (f"fused-kernel launches {run['launches']} >= likelihood batches "
                        f"run {run['batches']}")
        g = run["graph"]
        print(f"[9 {tag}] {text}; wall {run['wall']:.2f} s, {launches} "
              f"({run['rows']} rows evaluated; {g['captures']} graphs, {g['replays']} "
              f"replays, {g['reads']} flag reads)  [{smi}]")

    # (a) a seed ensemble at full width, merged by birth contours
    out = tmp / "seeds"
    out.mkdir()
    _write_cfg(out / "fit.cfg", out, run="seeds = 43,44")
    run = _drive_cli(out / "fit.cfg")
    merged, base = run["fits"][0]
    members = [_read_chain_pair(f"{base}_s{s}", 2 + 34) for s in (43, 44)]
    logz, err, post = _read_chain_pair(base, 2 + 34)
    stats = _stats_lines(base)
    if not (len(stats) == 4 and all(stats[1 + i].startswith(f"# seed {s}: logZ = ")
                                    and "insertion-rank KS p = " in stats[1 + i]
                                    for i, s in enumerate((43, 44)))
            and stats[3].startswith("# merged 2 seeds [43, 44] by birth contours")):
        raise AssertionError(f"seeds: bad merged .stats: {stats}")
    # solver = jaxns resamples every posterior to max_samples rows
    if (logz, err) != (merged.logz, merged.logzerr) or any(
            len(p) != SLICE_MAX_SAMPLES for p in (post, members[0][2], members[1][2])):
        raise AssertionError("seeds: the merged files are not the merged run's")
    if not run["stacked"]:
        raise AssertionError("seeds: the two seeds did not run as one fleet")
    report("a seeds", run,
           f"ndim=34 nlive=200 B=100 num_repeats={SLICE_NUM_REPEATS} max_samples="
           f"{SLICE_MAX_SAMPLES}, seeds 43 and 44 as one fleet: logZ {members[0][0]:.3f} and "
           f"{members[1][0]:.3f}, merged {logz:.3f} +/- {err:.3f} (unconverged by design), "
           f"merged equal-weight rows {len(post)}")

    # (b) kill and resume at full width, byte for byte
    ref, cut = tmp / "resume_ref", tmp / "resume_cut"
    for d in (ref, cut):
        d.mkdir()
        _write_cfg(d / "fit.cfg", d, max_samples=RESUME_MAX_SAMPLES,
                   num_repeats=RESUME_NUM_REPEATS,
                   run=f"seed = 43\ncheckpoint = {d / 'ckpt'}")
    run = _drive_cli(ref / "fit.cfg")
    res, ref_base = run["fits"][0]
    logz, err, _ = _read_chain_pair(ref_base, 2 + 34)
    kept = sorted(p.name for p in (ref / "ckpt").glob("ns_state_*.npz"))
    if kept != ["ns_state_000008.npz", "ns_state_000040.npz", "ns_state_000042.npz"]:
        raise AssertionError(f"resume: checkpoints of the uninterrupted run: {kept}")
    report("b uninterrupted", run,
           f"max_samples={RESUME_MAX_SAMPLES}, num_repeats={RESUME_NUM_REPEATS} with "
           f"[run] checkpoint: {res.n_iter} steps, "
           f"n_like={res.n_like}, logZ {logz:.3f} +/- {err:.3f}, checkpoints at steps 8, 40, 42")

    class Killed(RuntimeError):
        pass

    save_state, saves = runner.save_state, []

    def dying_save_state(*a, **k):
        save_state(*a, **k)
        saves.append(a[0])
        if len(saves) == 2:
            raise Killed("stopped after the second checkpoint")

    runner.save_state = dying_save_state
    try:
        _drive_cli(cut / "fit.cfg")
    except Killed as e:
        killed = e.drive
    else:
        raise AssertionError("resume: the fit outlived its kill")
    finally:
        runner.save_state = save_state
    cut_base = str(cut / "fits" / "pc_fits_0")
    if Path(cut_base + ".stats").exists() or [Path(p).name for p in saves] != kept[:2]:
        raise AssertionError(f"resume: the killed run left {saves} and maybe chain files")
    report("b killed", killed, f"stopped by the chunk callback after {Path(saves[1]).name}")
    run = _drive_cli(cut / "fit.cfg")
    again = run["fits"][0][0]
    for suffix in (".stats", "_equal_weights.txt"):
        if Path(cut_base + suffix).read_bytes() != Path(ref_base + suffix).read_bytes():
            raise AssertionError(f"resume: {suffix} differs from the uninterrupted run's")
    if again.n_like != res.n_like or run["rows"] >= killed["rows"]:
        raise AssertionError("resume: the second start did not go on from the checkpoint")
    report("b resumed", run,
           f"from {kept[1]}: n_like={again.n_like}, .stats and _equal_weights.txt byte for "
           "byte the uninterrupted run's")
    _write_cfg(cut / "seed44.cfg", cut, max_samples=RESUME_MAX_SAMPLES,
               num_repeats=RESUME_NUM_REPEATS,
               run=f"seed = 44\ncheckpoint = {cut / 'ckpt'}")
    try:
        _drive_cli(cut / "seed44.cfg")
    except ValueError as e:
        if "fingerprint mismatch on 'seed'" not in str(e):
            raise
        print(f"[9 b refused] seed 43's checkpoint offered to seed 44: {e}")
    else:
        raise AssertionError("resume: seed 44 took seed 43's checkpoint")

    # (c) dynamic sampling with a [pc_settings] section, at the anchor
    cfg = _anchor_cfg(tmp / "dynamic", solver="dypolychord", pc_settings=True)
    run = _drive_cli(cfg)
    (res, base), dyn = run["fits"][0], run["dynamic"][0]
    logz, err, post = _read_chain_pair(base, 2 + 4)
    near = _near_quadrature("dynamic", logz, err)
    ess = posterior_ess(dyn.base.log_posterior_weights), posterior_ess(dyn.merged.log_posterior_weights)
    if not ess[1] > ess[0]:
        raise AssertionError(f"dynamic: posterior ESS {ess[0]:.0f} -> {ess[1]:.0f}")
    stats = _stats_lines(base)
    if not (len(stats) == 3 and stats[1].startswith("# insertion-rank KS p = ")
            and stats[2].startswith("# boost insertion-rank KS p = ")):
        raise AssertionError(f"dynamic: bad .stats: {stats}")
    dead = np.loadtxt(base + "_dead-birth.txt", ndmin=2)
    rows = [int(np.isfinite(r.logw).sum()) for r in (dyn.base, dyn.boost)]
    prior_born = int(np.sum(dead[:, -1] == -1e30))
    boost_births = dead[rows[0]:, -1]  # the boost's first live set is born at l_init
    at_l_init = int(np.sum(boost_births == np.float32(dyn.l_init)))
    rebuilt = _deadbirth_logz(dead)
    if (dead.shape != (sum(rows), 4 + 2) or prior_born != ANCHOR_NLIVE
            or at_l_init != ANCHOR_NLIVE or not np.all(boost_births >= np.float32(dyn.l_init))
            or not abs(rebuilt - logz) < 3.0 * err + 0.3):
        raise AssertionError(f"dynamic: bad _dead-birth.txt: shape {dead.shape}, rows {rows}, "
                             f"{prior_born} prior-born, {at_l_init} born at l_init, logZ from "
                             f"it {rebuilt:.3f}")
    for prefix in ("ns_state", "ns_boost"):
        n = len(list(Path(base + "_resume").glob(f"{prefix}_*.npz")))
        if not 1 <= n <= 3:
            raise AssertionError(f"dynamic: {n} {prefix} checkpoints in {base}_resume")
    report("c dynamic", run,
           f"solver=dypolychord with [pc_settings], ndim=4 nlive={ANCHOR_NLIVE}: base n_like={dyn.base.n_like} "
           f"logZ {float(dyn.base.logz):.3f}, boost above lnL={dyn.l_init:.3f} n_like="
           f"{dyn.boost.n_like}, merged logZ {logz:.3f} +/- {err:.3f} ({near}), posterior ESS "
           f"{ess[0]:.0f} -> {ess[1]:.0f}, _dead-birth.txt rows {rows[0]} + {rows[1]} (logZ from "
           f"it {rebuilt:.3f}), base and boost checkpoints under {Path(base).name}_resume/")

    # (d) the repeats ladder from an under-mixed start
    cfg = _anchor_cfg(tmp / "ladder", ns="num_repeats = 2\nauto_repeats = True\n")
    run = _drive_cli(cfg, "--debug")
    res, base = run["fits"][0]
    logz, err, _ = _read_chain_pair(base, 2 + 4)
    stats = _stats_lines(base)
    m = re.match(r"# auto_repeats ladder converged=(True|False) \(rungs \[([0-9, ]+)\], "
                 r"final num_repeats=(\d+)\)", stats[1])
    if not m or len(stats) != 4 or not all(
            stats[2 + i].startswith(f"# seed{i} insertion-rank KS p = ") for i in (0, 1)):
        raise AssertionError(f"ladder: bad .stats: {stats}")
    rungs = [int(x) for x in m[2].split(",")]
    if len(rungs) < 2 or rungs != [2 << k for k in range(len(rungs))] or int(m[3]) != rungs[-1]:
        raise AssertionError(f"ladder: rungs {rungs}, final {m[3]}")
    near = _near_quadrature("ladder", logz, err)
    report("d ladder", run,
           f"auto_repeats from num_repeats=2, ndim=4 nlive={ANCHOR_NLIVE}: rungs {rungs}, converged={m[1]}, "
           f"merged logZ {logz:.3f} +/- {err:.3f} ({near})")

    # (e) the fixed-k grid
    cfg = _anchor_cfg(tmp / "grid", ncomp="1,2", run="ncomp_grid = True")
    run = _drive_cli(cfg)
    if len(run["fits"]) != 3:  # k = 1, k = 2, and the grid itself
        raise AssertionError(f"grid: {len(run['fits'])} run_fit calls")
    base = run["fits"][-1][1]
    per_k = {k: _read_chain_pair(f"{base}_k{k}", 2 + 1 + 3 * k) for k in (1, 2)}
    best = max(per_k, key=lambda k: per_k[k][0])
    table = Path(base + "_ncomp_grid.txt").read_text().splitlines()
    if (len(table) != 4 or table[0] != "# k  logZ  logZerr  dlogZ_vs_best"
            or [ln.split()[0] for ln in table[1:3]] != ["1", "2"]
            or [float(ln.split()[1]) for ln in table[1:3]] != [round(per_k[k][0], 4) for k in (1, 2)]
            or not table[3].startswith(f"# best k = {best}; trans-dimensional evidence")):
        raise AssertionError(f"grid: bad table {table}")
    for suffix in (".stats", "_equal_weights.txt"):
        if Path(base + suffix).read_bytes() != Path(f"{base}_k{best}{suffix}").read_bytes():
            raise AssertionError(f"grid: {suffix} is not the best k's")
    report("e grid", run,
           f"ncomp = 1, 2 with ncomp_grid, nlive={ANCHOR_NLIVE}: logZ k=1 {per_k[1][0]:.3f} +/- "
           f"{per_k[1][1]:.3f}, k=2 {per_k[2][0]:.3f} +/- {per_k[2][1]:.3f}, best k = {best} "
           f"copied to the base name; {table[3][2:]}")

    # (f) two spectra, one fit each
    cfg = _anchor_cfg(tmp / "spectra", specfile="civ_mock_spec.txt, civ_mock_spec_multicomp.txt")
    run = _drive_cli(cfg)
    fits = run["fits"][-1]  # the list of (results, base), one per spectrum
    stems = ("civ_mock_spec", "civ_mock_spec_multicomp")
    if len(fits) != 2 or [Path(b).name for _, b in fits] != [f"pc_fits_0_{s}" for s in stems]:
        raise AssertionError(f"spectra: fits under {[b for _, b in fits]}")
    pairs = [_read_chain_pair(b, 2 + 4) for _, b in fits]
    if not run["stacked"] or not all(p[1] > 0 for p in pairs):
        raise AssertionError(f"spectra: stacked calls {run['stacked']}, logzerr "
                             f"{[p[1] for p in pairs]}")
    report("f spectra", run,
           f"two spectra as one fleet, the 1-comp model on each, nlive={ANCHOR_NLIVE}: " + ", ".join(
               f"{s} n_like={r.n_like} logZ {p[0]:.3f} +/- {p[1]:.3f}"
               for s, (r, _), p in zip(stems, fits, pairs)))
    return total


FLEET_SEEDS = (43, 44, 45, 46)


def _flagship_setup(out: Path):
    """Phase 6's flagship slice as the runner sets it up: its config, model
    and sampler settings, on the current card."""
    from mcalf_torch import runner
    from mcalf_torch.config import readconfig
    from mcalf_torch.parallel import make_mesh

    out.mkdir()
    _write_cfg(out / "fit.cfg", out)
    cp = readconfig(str(out / "fit.cfg"))
    model = runner.build_model(cp)
    device = make_mesh()[0].device
    plan, cfg, _ = runner._sampler_configs(cp, model, device)
    return cp, model, plan, cfg, device


def phase_fleet(tmp: Path, smi: str, flagship: dict) -> dict:
    """Phase 10: ``fit_many`` on four seeds of phase 6's flagship slice,
    the first phase 6's own; one fused launch per stacked likelihood call
    run (each replayed iteration one call) and one ``slice_update`` launch
    per stacked slice iteration; seed 43's files, written as the runner
    writes a fit's, byte for byte phase 6's."""
    from mcalf_torch import runner
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models.torch_model import StackedForward
    from mcalf_torch.ops import slice_cuda, voigt_cuda
    from mcalf_torch.parallel import fit_many
    from mcalf_torch.sampler import graph
    from mcalf_torch.sampler.nested import unstack_results
    from mcalf_torch.utils.profiling import count_launch

    cp, model, plan, cfg, device = _flagship_setup(tmp / "fleet")
    gens = [torch.Generator(device=device).manual_seed(s) for s in FLEET_SEEDS]
    loglike_cube, calls = StackedForward.loglike_cube, []

    def counted(self, u, prob):  # a call counts when the card runs it
        count_launch(lambda n, rows=u.shape[0]: calls.extend([rows] * n))
        return loglike_cube(self, u, prob)

    StackedForward.loglike_cube = counted
    try:
        voigt_cuda.launches = 0
        slice_cuda.launches = 0
        graph.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_many([model] * len(FLEET_SEEDS), cfg, mesh=[device], generators=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = voigt_cuda.launches
        slices = slice_cuda.launches
        g = dict(graph.stats)
    finally:
        StackedForward.loglike_cube = loglike_cube
    members = [r.numpy() for r in unstack_results(res)]
    run_calls = len(calls)
    if launches != run_calls:
        raise AssertionError(f"fleet: {launches} fused launches for {run_calls} stacked calls run")
    n_like = sum(r.n_like for r in members)
    rows = sum(calls)
    if rows < n_like:
        raise AssertionError(f"fleet: {rows} rows evaluated, members count {n_like}")
    fwd = make_torch_forward(model, device)
    base = runner._write_fit(cp, fwd, members[0], [("", members[0], cfg)], plan, cfg, [], False)
    for suffix in (".stats", "_equal_weights.txt"):
        if Path(base + suffix).read_bytes() != Path(flagship["base"] + suffix).read_bytes():
            raise AssertionError(f"fleet: seed 43's {suffix} differs from phase 6's flagship slice")
    rate, solo = n_like / wall, flagship["n_like"] / flagship["wall"]
    iters = run_calls - 1  # the first call evaluates the four initial live sets
    if slices != iters:
        raise AssertionError(f"fleet: {slices} slice_update launches for {iters} stacked slice "
                             "iterations run")
    steps = max(r.n_iter for r in members)
    print(
        f"[10 fleet] fit_many, seeds {list(FLEET_SEEDS)} of the flagship slice (ndim 34, nlive "
        f"200, B=100, {SLICE_NUM_REPEATS} repeats, max_samples {SLICE_MAX_SAMPLES}): wall "
        f"{wall:.2f} s, {n_like} evaluations ({[r.n_like for r in members]}) of {rows} rows "
        f"evaluated, {iters} stacked slice iterations run (1 warm-up + {g['replays']} replays) "
        f"+ 1 initial call = {launches} fused launches ({slices} slice_update launches), "
        f"{g['replays'] / steps:.2f} replays and "
        f"{g['reads'] / steps:.2f} flag reads per outer step, {wall / iters * 1e3:.4f} ms per "
        f"stacked iteration; logZ {[round(float(r.logz), 3) for r in members]}; seed 43's "
        f".stats and _equal_weights.txt byte for byte phase 6's"
    )
    print(
        f"[10 fleet] aggregate {rate:.4g} evals/s against the solo flagship slice's "
        f"{solo:.4g} evals/s (phase 6, {flagship['wall']:.2f} s, {flagship['launches']} "
        f"launches): {rate / solo:.3f}x  [{smi}]"
    )
    return {"launches": launches, "slice_launches": slices, "wall": wall, "n_like": n_like,
            "rate": rate, "solo_rate": solo, "members": members, "iterations": iters, "graph": g}


#: seconds of idle time at each end of a profiled window
TRACE_MARGIN_S = 0.2


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


#: the kernel a likelihood call launches once, and its wrapper's count
PROFILED_KERNELS = {"fused_loglike_kernel": "launches", "voigt_tau_kernel": "tau_launches"}


def _kernel_class(name: str) -> str:
    """A device kernel's class in a profile's breakdown."""
    for k in PROFILED_KERNELS:
        if k in name:
            return k
    if "index" in name.lower() or "gather" in name.lower():
        return "gathers"
    return "reductions" if "reduce_kernel" in name else "elementwise and other"


def _profile_window(tag: str, trace_dir: Path, loglike_rows, states, gens, cfg, loop,
                    kernel: str = "fused_loglike_kernel") -> dict:
    """One outer step of the problems in ``states`` under torch.profiler
    (``mcalf_torch.utils.profiling.trace``), after one step outside it that
    captures the graph: CUDA kernel launches, graph launches and host
    synchronisations per slice iteration run, from the trace's runtime
    events, the device's busy share of the window's wall (the union of its
    kernel, copy and set intervals), and the device time per iteration of
    each class of kernel (:func:`_kernel_class`) and of the costliest
    kernels.  ``kernel``'s runs in the trace (the fused kernel, or the tau
    kernel outside ``'same_edge'``) must equal the launches its wrapper
    counted in the window (a captured launch counts at each replay)."""
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.sampler import nested
    from mcalf_torch.utils.profiling import trace

    counter = PROFILED_KERNELS[kernel]
    cfg = cfg.resolved()
    probs = list(range(len(states)))
    cum = nested._cum_dlogx(cfg, states[0].live_u.device)
    graphs = {}
    states = nested._steps(loglike_rows, states, gens, probs, cfg, cum, loop, graphs)
    before = getattr(voigt_cuda, counter)
    torch.cuda.synchronize()
    with trace(str(trace_dir / tag)):
        # idle margins: the profiler keeps only device events it dates
        # inside its window, and it dates them by another clock
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        nested._steps(loglike_rows, states, gens, probs, cfg, cum, loop, graphs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(TRACE_MARGIN_S)
    iters = getattr(voigt_cuda, counter) - before
    [path] = (trace_dir / tag).glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    runtime = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            runtime[e["name"]] = runtime.get(e["name"], 0) + 1
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    runs = sum(1 for e in events if e.get("cat") == "kernel" and kernel in e.get("name", ""))
    if runs != iters:
        graph_launches = {e["args"].get("correlation") for e in events
                          if e.get("cat") == "cuda_runtime" and e["name"] == "cudaGraphLaunch"}
        per_launch = collections.Counter(
            e["args"].get("correlation") for e in events if e.get("cat") == "kernel"
            and kernel in e.get("name", "") and e["args"].get("correlation") in graph_launches)
        raise AssertionError(
            f"loops: {tag}'s trace holds {runs} {kernel} runs, voigt_cuda.{counter} "
            f"counted {iters}; runs per cudaGraphLaunch in the trace (runs: launches): "
            f"{dict(collections.Counter(per_launch[c] for c in graph_launches))}")
    busy = _union_us(device)
    classes, names = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            classes[_kernel_class(e["name"])] += e["dur"] / iters
            names[e["name"].split("(")[0].removeprefix("void ")[:120]] += e["dur"] / iters
    return {
        "iterations": iters,
        "kernel_events": runs,
        "kernel_us_per_iter": dict(classes.most_common()),
        "top_kernels_us_per_iter": dict(names.most_common(8)),
        "launches_per_iter": sum(n for k, n in runtime.items()
                                 if k.startswith("cudaLaunchKernel")) / iters,
        "graph_launches_per_iter": runtime.get("cudaGraphLaunch", 0) / iters,
        "syncs_per_iter": sum(n for k, n in runtime.items() if "Synchronize" in k) / iters,
        "device_events": len(device),
        "busy_share": busy / wall_us if device else None,
        "device_us_per_iter": busy / iters,
        "wall_ms_per_iter_profiled": wall_us / iters / 1e3,
    }


def phase_loops(tmp: Path, smi: str, flagship: Optional[dict], fleet: Optional[dict],
                ks: Sequence[int] = (), profile: bool = True) -> dict:
    """Phase 11: the captured slice loop against the eager one
    (``_loop="eager"``) on phase 6's flagship slice (seed 43) and on phase
    10's fleet of four seeds, in turns: captured at each block size of
    ``ks`` (default: the sampler's ``BLOCK_ITERATIONS``), eager, captured at
    each k again in reverse.  Every turn's chain files or results byte for
    byte phase 6's and phase 10's (with ``flagship`` / ``fleet`` None: the
    eager turn's); ms per slice iteration run, evals/s, replays and flag
    reads per outer step; then, with ``profile``, one profiled outer step of
    each loop (launches, graph launches and syncs per iteration, the
    device's busy share).  ``tools/slice_blocks.py`` runs it at several k."""
    from mcalf_torch import runner
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.sampler import finalize, graph, init_state, nested, nested_sample
    from mcalf_torch.sampler.nested import nested_sample_stacked

    cp, model, plan, cfg, device = _flagship_setup(tmp / "loops")
    gp = model.gpriors is not None
    fwd = make_torch_forward(model, device, gpriors=gp)
    sf = make_stacked_forward(*stack_problems([model] * len(FLEET_SEEDS), gpriors=gp), device)
    default_k = nested.BLOCK_ITERATIONS
    ks = list(ks) or [default_k]

    def timed(fn, k):
        nested.BLOCK_ITERATIONS = k
        voigt_cuda.launches = 0
        graph.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            nested.BLOCK_ITERATIONS = default_k
        wall = time.perf_counter() - t0
        return dict(out=out, wall=wall, iterations=voigt_cuda.launches - 1, graph=dict(graph.stats))

    def solo(loop, k):
        gen = torch.Generator(device=device).manual_seed(FLEET_SEEDS[0])
        return timed(lambda: [nested_sample(fwd.loglike_cube, gen, cfg, device, _loop=loop).numpy()], k)

    def stacked(loop, k):
        gens = [torch.Generator(device=device).manual_seed(s) for s in FLEET_SEEDS]
        return timed(lambda: [finalize(f, cfg).numpy() for f in nested_sample_stacked(
            sf.loglike_cube, gens, cfg, device, _loop=loop)], k)

    def same(a, b):
        return (a.n_like == b.n_like and np.array_equal(a.samples_u, b.samples_u)
                and np.array_equal(a.logl, b.logl) and a.logz == b.logz)

    rows = {}
    for name, run in (("solo", solo), ("fleet", stacked)):
        turns = ([(k, run(None, k)) for k in ks] + [(None, run("eager", default_k))]
                 + [(k, run(None, k)) for k in reversed(ks)])
        eager = next(t for k, t in turns if k is None)
        if name == "solo" and flagship is not None:
            held = "files byte for byte phase 6's"
        elif name == "fleet" and fleet is not None:
            held, ref = "members bit for bit phase 10's", fleet["members"]
        else:
            held, ref = "results bit for bit the eager turn's", eager["out"]
        for i, (k, t) in enumerate(turns):
            t["n_like"] = sum(r.n_like for r in t["out"])
            if held.startswith("files"):
                res = t["out"][0]
                base = runner._write_fit(cp, fwd, res, [("", res, cfg)], plan, cfg, [], False)
                for suffix in (".stats", "_equal_weights.txt"):
                    if Path(base + suffix).read_bytes() != Path(flagship["base"] + suffix).read_bytes():
                        raise AssertionError(f"loops: solo turn {i}'s {suffix} differs from phase 6's")
            elif not all(same(a, b) for a, b in zip(t["out"], ref)):
                raise AssertionError(f"loops: {name} turn {i} differs; want {held}")
        rows[name] = rec = dict(
            eager_ms_per_iter=eager["wall"] / eager["iterations"] * 1e3,
            eager_evals_per_s=eager["n_like"] / eager["wall"], eager_wall_s=eager["wall"],
            eager_iterations=eager["iterations"], captured={},
        )
        for k in ks:
            cap = [t for kk, t in turns if kk == k]
            steps = max(r.n_iter for r in cap[0]["out"])
            rec["captured"][k] = c = dict(
                ms_per_iter=[t["wall"] / t["iterations"] * 1e3 for t in cap],
                evals_per_s=[t["n_like"] / t["wall"] for t in cap],
                wall_s=[t["wall"] for t in cap], iterations=cap[0]["iterations"],
                beyond_eager=cap[0]["iterations"] - cap[0]["graph"]["warmups"] - eager["iterations"],
                replays=cap[0]["graph"]["replays"], reads=cap[0]["graph"]["reads"], steps=steps,
            )
            speedup = [r / rec["eager_evals_per_s"] for r in c["evals_per_s"]]
            print(
                f"[11 loops] {name} flagship slice (seed{'s' if name == 'fleet' else ''} "
                f"{list(FLEET_SEEDS) if name == 'fleet' else FLEET_SEEDS[0]}), k = {k}, captured / "
                f"eager / captured: {c['wall_s'][0]:.2f} / {rec['eager_wall_s']:.2f} / "
                f"{c['wall_s'][1]:.2f} s, {c['ms_per_iter'][0]:.4f} / "
                f"{rec['eager_ms_per_iter']:.4f} / {c['ms_per_iter'][1]:.4f} ms per slice "
                f"iteration run ({c['iterations']} captured, {c['beyond_eager']} of them beyond "
                f"the eager {rec['eager_iterations']}), {c['evals_per_s'][0]:.4g} / "
                f"{rec['eager_evals_per_s']:.4g} / {c['evals_per_s'][1]:.4g} evals/s "
                f"({speedup[0]:.2f}x, {speedup[1]:.2f}x); {c['replays'] / steps:.2f} replays and "
                f"{c['reads'] / steps:.2f} flag reads per outer step; every turn's {held}  [{smi}]"
            )
    if not profile:
        return rows
    trace_dir = tmp / "traces"
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    for name in ("solo", "fleet"):
        seeds = FLEET_SEEDS[:1] if name == "solo" else FLEET_SEEDS
        for loop in ("eager", None):
            gens = [gen(s) for s in seeds]
            states = [init_state(fwd.loglike_cube, g, cfg, device) for g in gens]
            ll = (lambda u, prob: fwd.loglike_cube(u)) if name == "solo" else sf.loglike_cube
            w = _profile_window(f"{name}_{loop or 'captured'}", trace_dir, ll, states, gens, cfg, loop)
            rows[name]["profile_" + (loop or "captured")] = w
            busy = "not measured (no device events)" if w["busy_share"] is None else f"{w['busy_share']:.3f}"
            print(
                f"[11 loops] {name} {loop or 'captured'}, one profiled outer step ({w['iterations']} "
                f"slice iterations, {w['kernel_events']} fused_loglike_kernel runs in the "
                f"trace = the launches counted): {w['launches_per_iter']:.2f} CUDA launches, "
                f"{w['graph_launches_per_iter']:.4f} cudaGraphLaunch and {w['syncs_per_iter']:.4f} "
                f"syncs per iteration; device busy share {busy}, {w['device_us_per_iter']:.1f} us of "
                f"device work and {w['wall_ms_per_iter_profiled']:.4f} ms of profiled wall per "
                f"iteration  [{smi}]"
            )
            print(f"[11 loops] {name} {loop or 'captured'}: device us per iteration by class "
                  f"{_rounded(w['kernel_us_per_iter'])}")
    return rows


def _rounded(d: dict) -> dict:
    return {k: round(v, 2) for k, v in d.items()}


def _recording_plots():
    """Replace ``plotting.plot_data`` by a wrapper that keeps what each call
    returned; returns (the list, a function that puts the original back)."""
    from mcalf_torch import plotting

    made, plot_data = [], plotting.plot_data
    plotting.plot_data = lambda *a, **k: made.append(plot_data(*a, **k)) or made[-1]

    def restore():
        plotting.plot_data = plot_data

    return made, restore


def _check_overlays(tag: str, d, model) -> tuple:
    """A plot's overlays computed on the card: every value finite, within
    1e-5 of the plain version on the CPU and of the port's float64 numpy
    ``reconstruct_spec`` (the never-active columns at 0, as numpy reads
    only active components).  Returns the two largest |dflux|."""
    from mcalf_torch import plotting
    from mcalf_torch.models import make_torch_forward

    if d.overlays.shape != (min(len(d.draws), 100), model.npix) or not np.all(np.isfinite(d.overlays)):
        raise AssertionError(f"{tag}: overlays {d.overlays.shape}, finite "
                             f"{np.isfinite(d.overlays).all()}")
    plain = plotting.posterior_overlays(model, make_torch_forward(model, "cpu", conv_mode="wrap"), d.draws)
    numpy = np.stack([model.reconstruct_spec(np.nan_to_num(r, nan=0.0)) for r in d.draws])
    d_plain = float(np.max(np.abs(d.overlays - plain)))
    d_numpy = float(np.max(np.abs(d.overlays - numpy)))
    if not (d_plain < 1e-5 and d_numpy < 1e-5):
        raise AssertionError(f"{tag}: max |dflux| {d_plain} vs plain, {d_numpy} vs numpy")
    return d_plain, d_numpy


def phase_plot(tmp: Path, smi: str) -> dict:
    """Phase 12: ``mcalf_torch.cli.main`` with ``dofit = False``, ``doplot =
    True`` on phase 6's flagship chain files: one ``voigt_tau`` launch for
    the 100 posterior-draw overlays, which match the plain version on the
    CPU and the port's float64 numpy ``reconstruct_spec`` to |dflux| <
    1e-5, every value finite."""
    from mcalf_torch import cli
    from mcalf_torch.config import readconfig
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.runner import build_model

    cfg = tmp / "flagship" / "plot.cfg"
    cfg.write_text((tmp / "flagship" / "fit.cfg").read_text()
                   .replace("dofit = True", "dofit = False").replace("doplot = False", "doplot = True"))
    made, restore = _recording_plots()
    try:
        voigt_cuda.launches = voigt_cuda.tau_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main([str(cfg)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fused = voigt_cuda.tau_launches, voigt_cuda.launches
    finally:
        restore()
    if rc != 0 or len(made) != 1 or launches != 1 or fused != 0:
        raise AssertionError(f"plot: rc {rc}, {len(made)} plots, {launches} voigt_tau and "
                             f"{fused} fused launches (want one plot, one voigt_tau launch)")
    d = made[0]
    model = build_model(readconfig(str(cfg)))
    d_plain, d_numpy = _check_overlays("plot", d, model)
    print(
        f"[12 plot] flagship chain files (phase 6) through cli.main, doplot only: wall "
        f"{wall:.3f} s, voigt_tau launches {launches} for {len(d.draws)} overlays of "
        f"{model.npix} pixels (T={2 * model.ncompmax}), all finite; max |dflux| {d_plain:.3g} "
        f"vs the plain version on the CPU, {d_numpy:.3g} vs numpy reconstruct_spec (float64); "
        f"banner Chi2 {d.chi2:.3f}, MAP ncomp {d.map_ncomp}  [{smi}]"
    )
    return {"launches": launches, "fused_launches": fused, "wall": wall,
            "max_abs_err": max(d_plain, d_numpy)}


def _hi_kernel_check(model, nseeds: int) -> dict:
    """Both kernels at the HI forest's shapes against their plain versions
    on the same inputs, at phase 3's and phase 4's tolerances: one stacked
    likelihood call of the seeds' fleet (``StackedForward``, nseeds x 50
    rows interleaved, ncomp 1-3 so some components masked), one solo B=100
    call, and ``voigt_tau`` at B=100."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.ops import voigt_cuda

    spec, stacked = stack_problems([model] * nseeds)
    sf = tm.make_stacked_forward(spec, stacked, "cuda")
    fwd = make_torch_forward(model, "cuda")
    kw = dict(half=spec.half, asymm=spec.asymmlike)
    out = {}
    for what, B in (("stacked", nseeds * 50), ("solo", 100)):
        u = _batch(spec.ndim, B, False, seed=130 + B, layout=None)
        if what == "stacked":
            prob = torch.arange(B, device="cuda", dtype=torch.int32) % nseeds
            p, c, args = _stacked_args(sf, u, prob)
            extra = dict(prob=prob)
        else:
            c = fwd.consts()
            p, args = _fused_args(fwd, u)
            extra = {}
        k = voigt_cuda.fused_loglike(*args, **kw, **extra)
        q = voigt_cuda.fused_loglike_plain(*args, **kw, **extra)
        lk = tm.loglike_from_fused(p, c, spec, *k).double().cpu().numpy()
        lp = tm.loglike_from_fused(p, c, spec, *q).double().cpu().numpy()
        ck, cq = k[0].double().cpu().numpy(), q[0].double().cpu().numpy()
        if not np.allclose(ck, cq, rtol=1e-5, atol=0.1):
            raise AssertionError(f"hi_forest {what} B={B}: max |dchi2| {np.max(np.abs(ck - cq))}")
        if not np.array_equal(np.isfinite(lk), np.isfinite(lp)):
            raise AssertionError(f"hi_forest {what} B={B}: -inf pattern differs")
        fin = np.isfinite(lk)
        err = float(np.max(np.abs(lk[fin] - lp[fin]), initial=0.0))
        if not np.allclose(lk[fin], lp[fin], rtol=1e-5, atol=0.05):
            raise AssertionError(f"hi_forest {what} B={B}: max |dlogL| {err}")
        nact = np.floor(p[:, spec.startind].double().cpu().numpy()).astype(int)
        out[what] = (B, err, int(fin.sum()), sorted(set(nact.tolist())))
        if what == "solo":
            targs = _tau_args(args)
            kt, qt = voigt_cuda.voigt_tau(*targs), voigt_cuda.voigt_tau_plain(*targs)
            rel = float(((kt - qt).abs() / (qt.abs() + 1e-3)).max())
            if not rel < 3e-5:
                raise AssertionError(f"hi_forest tau B={B}: max rel err {rel}")
            out["tau"] = (B, rel, float((kt - qt).abs().max()))
    return out


#: the JAX package's HI-forest evidence, seeds 1-48 in order, on the CPU
#: (no jax on the card's machine): ``JAX_PLATFORMS=cpu python3
#: tools/hi_forest_seeds.py --package mcalf_tpu --seeds 1,...,16 --jobs 2``
#: and ``--seeds 17,...,48 --jobs 3`` (testdata/hi_forest.cfg at its shipped
#: settings, ``[run] seed = s``, through ``python -m mcalf_tpu``; mcalf_tpu as
#: at commit 375a904), every run converged.  The JAX package's CPU runs do
#: not repeat a seed's logZ, so these are one reading of each seed.
HI_JAX_LOGZ = (
    924.417, 924.991, 923.732, 924.376, 924.668, 924.079, 924.436, 925.144,
    924.369, 924.577, 923.475, 924.746, 922.279, 923.117, 924.660, 925.155,
    924.382, 924.417, 925.588, 924.333, 924.963, 923.576, 924.662, 924.296,
    925.390, 923.164, 921.848, 923.709, 924.996, 924.236, 923.305, 923.626,
    923.660, 923.848, 923.786, 924.613, 924.059, 924.144, 924.128, 924.859,
    923.416, 924.419, 925.269, 924.474, 924.390, 923.987, 923.866, 926.760,
)
#: the port's, seeds 1-80 in order: ``python3 tools/hi_forest_seeds.py
#: --seeds 1,...,16`` and ``--seeds 17,...,80`` (two fleets) on an NVIDIA H100
#: 80GB HBM3 at 700 W; a captured fleet repeats its logZ bit for bit, and a
#: member's files are the same in any fleet (seed 2 alone or among 1-4)
HI_PORT_LOGZ = (
    924.324, 927.542, 924.991, 924.909, 924.790, 923.676, 924.820, 924.786,
    925.715, 925.182, 923.635, 924.387, 924.105, 923.672, 922.878, 925.909,
    925.894, 924.410, 923.599, 922.594, 924.771, 923.979, 925.044, 924.240,
    924.122, 924.215, 924.746, 924.277, 924.874, 924.623, 924.484, 923.977,
    923.612, 923.362, 924.679, 922.479, 923.665, 924.222, 924.552, 926.047,
    924.049, 924.109, 922.568, 925.373, 923.042, 924.213, 924.507, 923.463,
    924.744, 925.221, 924.735, 924.415, 923.356, 923.878, 925.075, 923.834,
    925.450, 924.693, 925.038, 923.589, 921.915, 924.331, 923.900, 925.551,
    925.198, 923.815, 925.308, 923.110, 923.787, 924.346, 925.786, 924.929,
    926.382, 924.571, 925.637, 923.717, 923.591, 924.185, 925.609, 923.102,
)
#: the gate's constants: the JAX mean, and both packages' per-seed sd
HI_JAX_LOGZ_MEAN = float(np.mean(HI_JAX_LOGZ))
HI_JAX_LOGZ_SD = float(np.std(HI_JAX_LOGZ, ddof=1))
HI_PORT_LOGZ_SD = float(np.std(HI_PORT_LOGZ, ddof=1))
#: the fleet phase 13 runs: the first 16 seeds (the JAX reference's first
#: set); seeds 1-4 alone read 1.183 from the JAX mean against their gate of
#: 0.985, seed 2 being the port's highest of 80 (927.542, 3.3 sd)
HI_SEEDS = tuple(range(1, 17))


def phase_hi_forest(tmp: Path, smi: str) -> dict:
    """Phase 13: testdata/hi_forest.cfg at its shipped settings through
    ``mcalf_torch.cli.main`` with ``[run] seeds`` = HI_SEEDS (one fleet) and
    its plot: MAP ncomp 2 and the three absorbers within 0.5 A on every
    seed and the merge, one fused launch per stacked likelihood call, one
    voigt_tau launch for the plot, whose overlays hold against the plain
    version and numpy; both kernels against their plain versions at the
    fit's shapes; the seeds' mean logZ within 2 hypot(sd_jax / sqrt(n_jax),
    sd_port / sqrt(n)) of the JAX package's mean, both sd stored."""
    from mcalf_torch import mocks, runner
    from mcalf_torch.analysis import analyze_chains
    from mcalf_torch.config import readconfig
    from mcalf_torch.models.torch_model import line_modes, static_spec
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.sampler.nested import unstack_results

    cfg = mocks.hi_forest_config(str(tmp / "hi_forest"), str(TESTDATA),
                                 f"seeds = {','.join(map(str, HI_SEEDS))}")
    cp = readconfig(cfg)
    model = runner.build_model(cp)
    spec = static_spec(model)
    modes = list(line_modes(spec))
    damped = voigt_cuda.MODE_HJERT in modes
    fits, fit_stacked = [], runner.fit_stacked

    def timed_fit(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_stacked(*a, **k)
        torch.cuda.synchronize()
        fits.append((res, time.perf_counter() - t0))
        return res

    runner.fit_stacked = timed_fit
    made, restore = _recording_plots()
    try:
        voigt_cuda.tau_launches = 0
        run = _drive_cli(Path(cfg))
        tau = voigt_cuda.tau_launches
    finally:
        runner.fit_stacked = fit_stacked
        restore()
    _check_launches("hi_forest", run)
    if len(fits) != 1 or tau != 1 or len(made) != 1:
        raise AssertionError(f"hi_forest: {len(fits)} fleet fits, {tau} voigt_tau launches, "
                             f"{len(made)} plots (want one each)")
    members = [r.numpy() for r in unstack_results(fits[0][0])]
    fit_wall = fits[0][1]
    if any(r.termination_reason != 0 for r in members):
        raise AssertionError("hi_forest: a seed hit max_samples before converging")
    base = runner.chain_basename(cp)
    rows, logz = [], []
    for tag, b in [(f"seed {s}", f"{base}_s{s}") for s in HI_SEEDS] + [("merged", base)]:
        lz, err, _, post = analyze_chains(b, nfill=model.nfill)
        mapn, wobs, _ = mocks.hi_absorbers(post, model)
        off = max(abs(w - f) for w, f in zip(wobs, mocks.HI_FEATURES))
        if mapn != 2 or not off < 0.5:
            raise AssertionError(f"hi_forest {tag}: MAP ncomp {mapn}, absorbers {wobs} "
                                 f"against {mocks.HI_FEATURES}")
        rows.append(f"{tag} logZ {lz:.3f} +/- {err:.3f}, MAP ncomp {mapn}, absorbers "
                    f"{', '.join(f'{w:.2f}' for w in wobs)} A (max offset {off:.3f})")
        if tag != "merged":
            logz.append(lz)
    d_plain, d_numpy = _check_overlays("hi_forest plot", made[0], model)
    checks = _hi_kernel_check(model, len(HI_SEEDS))
    mean = float(np.mean(logz))
    gate = 2.0 * math.hypot(HI_JAX_LOGZ_SD / math.sqrt(len(HI_JAX_LOGZ)),
                            HI_PORT_LOGZ_SD / math.sqrt(len(logz)))
    stored = [HI_PORT_LOGZ[s - 1] for s in HI_SEEDS]
    same = bool(np.allclose(logz, stored, rtol=0.0, atol=6e-4))
    n_like = sum(int(r.n_like) for r in members)
    ns = ", ".join(f"{k} {v}" for k, v in cp["ns_settings"].items())
    print(f"[13 hi_forest] testdata/hi_forest.cfg (ndim {model.ndim}, P={model.npix}, "
          f"T={spec.ntrans}, half {spec.half}, {ns}), seeds {list(HI_SEEDS)} as one fleet: "
          f"mode table {modes} -> the {'damped' if damped else 'Harris-only'} "
          "instantiation of both kernels")
    for line in rows:
        print(f"[13 hi_forest] {line}")
    g = run["graph"]
    print(
        f"[13 hi_forest] fit wall {fit_wall:.2f} s, {n_like} evaluations "
        f"({[int(r.n_like) for r in members]}), {n_like / fit_wall:.4g} evals/s; CLI wall "
        f"{run['wall']:.2f} s with the plot; fused-kernel launches {run['launches']} = stacked "
        f"likelihood calls run {run['stacked']} ({g['replays']} replays, {g['reads']} flag "
        f"reads); voigt_tau launches {tau} (the plot)  [{smi}]"
    )
    print(f"[13 hi_forest] plot: {len(made[0].draws)} overlays of {model.npix} pixels, all "
          f"finite; max |dflux| {d_plain:.3g} vs the plain version on the CPU, {d_numpy:.3g} "
          f"vs numpy reconstruct_spec (float64); banner Chi2 {made[0].chi2:.3f}")
    for what in ("stacked", "solo"):
        B, err, fin, ncomp = checks[what]
        print(f"[13 hi_forest] fused kernel, {what} call of {B} rows"
              f"{f' ({len(HI_SEEDS)} problems interleaved)' if what == 'stacked' else ''}, "
              f"ncomp {ncomp}: max |dlogL| vs plain {err:.3g}, finite {fin}/{B}")
    B, rel, abs_err = checks["tau"]
    print(f"[13 hi_forest] voigt_tau B={B}: max |dtau|/(|tau|+1e-3) {rel:.3g}, max |dtau| "
          f"{abs_err:.3g}")
    ok = abs(mean - HI_JAX_LOGZ_MEAN) < gate
    print(f"[13 hi_forest] {len(logz)} seeds' mean logZ {mean:.4f} (sd "
          f"{float(np.std(logz, ddof=1)):.3f}; each seed as stored: {same}) vs the JAX "
          f"package's {HI_JAX_LOGZ_MEAN:.4f} (sd {HI_JAX_LOGZ_SD:.4f}, {len(HI_JAX_LOGZ)} seeds, "
          f"CPU), the port's stored sd {HI_PORT_LOGZ_SD:.4f} ({len(HI_PORT_LOGZ)} seeds): |d| "
          f"{abs(mean - HI_JAX_LOGZ_MEAN):.4f} < 2 hypot(sd_jax/sqrt({len(HI_JAX_LOGZ)}), "
          f"sd_port/sqrt({len(logz)})) = {gate:.4f}: {ok}")
    if not ok:
        raise AssertionError("hi_forest: mean logZ outside the gate of the JAX package's")
    return {"launches": run["launches"], "tau_launches": tau, "wall": fit_wall, "n_like": n_like,
            "max_abs_err": max(checks["stacked"][1], checks["solo"][1]),
            "max_abs_dflux": max(d_plain, d_numpy)}


#: phase 14 (b): the JAX package's step-out battery
#: (tests/test_sampler.py::test_stepout_bracket_evidence), its settings and bar
STEPOUT_BATTERY = dict(ndim=4, sigma=0.06, nlive=100, num_repeats=48, max_samples=4000,
                       precision_criterion=1e-3, seeds=6, bar=0.27)
#: phase 14 (c): the seeds of the two-process fleet
DIST_SEEDS = (43, 44, 45, 46)
#: phase 14 (c): the time limit of the torchrun call
DIST_TIMEOUT_S = 600


def phase_stepout(tmp: Path, smi: str, flagship: dict) -> dict:
    """Phase 14 (a): phase 6's flagship slice with ``[ns_settings] bracket =
    stepout`` through ``cli.main``, captured and then with the eager loop
    (``runner.nested_sample`` given ``_loop="eager"``): the chain files
    byte for byte the same, and every likelihood call run one fused
    launch; evaluations and ms per slice iteration beside phase 6's chord
    slice."""
    import functools

    from mcalf_torch import runner

    nested_sample = runner.nested_sample
    runs = {}
    for loop in ("captured", "eager"):
        out = tmp / f"stepout_{loop}"
        out.mkdir()
        _write_cfg(out / "fit.cfg", out, ns="bracket = stepout\n")
        if loop == "eager":
            runner.nested_sample = functools.partial(nested_sample, _loop="eager")
        try:
            run = _drive_cli(out / "fit.cfg")
        finally:
            runner.nested_sample = nested_sample
        if run["rc"] != 0 or len(run["fits"]) != 1:
            raise AssertionError(f"stepout {loop}: cli.main returned {run['rc']}")
        res, base = run["fits"][0]
        _read_chain_pair(base, 2 + 34)
        g = run["graph"]
        if run["launches"] != run["batches"] or g["captures"] != (loop == "captured"):
            raise AssertionError(f"stepout {loop}: {run['launches']} fused launches for "
                                 f"{run['batches']} likelihood calls run, {g['captures']} graphs")
        runs[loop] = dict(run=run, res=res, base=base, iterations=run["launches"] - 1)
    for suffix in (".stats", "_equal_weights.txt"):
        a, b = (Path(runs[k]["base"] + suffix).read_bytes() for k in ("captured", "eager"))
        if a != b:
            raise AssertionError(f"stepout: the captured and eager {suffix} differ")
    for loop, r in runs.items():
        res, run = r["res"], r["run"]
        print(
            f"[14 stepout] flagship slice, bracket = stepout, {loop}: {res.n_iter} steps, "
            f"n_like={res.n_like} ({res.n_like / flagship['n_like']:.4f}x the chord's "
            f"{flagship['n_like']}), logZ {float(res.logz):.3f}, wall {run['wall']:.2f} s, "
            f"{res.n_like / run['wall']:.4g} evals/s, fused launches {run['launches']} = "
            f"likelihood calls run {run['batches']}, {r['iterations']} slice iterations run "
            f"({run['graph']['replays']} replays), {run['wall'] / r['iterations'] * 1e3:.4f} ms "
            f"per iteration (chord, phase 6: {flagship['wall'] / flagship['iterations'] * 1e3:.4f} "
            f"ms, {flagship['iterations']} iterations)  [{smi}]"
        )
    print("[14 stepout] captured and eager chain files byte for byte the same")
    cap = runs["captured"]
    return {"launches": cap["run"]["launches"], "launches_eager": runs["eager"]["run"]["launches"],
            "n_like": cap["res"].n_like, "chord_n_like": flagship["n_like"],
            "ms_per_iter": cap["run"]["wall"] / cap["iterations"],
            "eager_ms_per_iter": runs["eager"]["run"]["wall"] / runs["eager"]["iterations"]}


def phase_stepout_battery(smi: str) -> dict:
    """Phase 14 (b): the step-out bracket's evidence on the card, the JAX
    package's battery (an isotropic Gaussian, logZ = 0): the mean over its
    6 seeds within 0.27 of 0."""
    from mcalf_torch.sampler import NSConfig, nested_sample

    b = STEPOUT_BATTERY
    ndim, sigma = b["ndim"], b["sigma"]
    norm = -0.5 * ndim * math.log(2 * math.pi * sigma**2)

    def ll(u):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(torch.float32)

    cfg = NSConfig(ndim=ndim, nlive=b["nlive"], num_repeats=b["num_repeats"],
                   max_samples=b["max_samples"], precision_criterion=b["precision_criterion"],
                   bracket="stepout")
    t0 = time.perf_counter()
    runs = [nested_sample(ll, torch.Generator(device="cuda").manual_seed(s), cfg, "cuda").numpy()
            for s in range(b["seeds"])]
    wall = time.perf_counter() - t0
    zs = [float(r.logz) for r in runs]
    mean = float(np.mean(zs))
    ok = abs(mean) < b["bar"] and all(r.termination_reason == 0 for r in runs)
    print(f"[14 stepout] Gaussian battery (ndim 4, sigma 0.06, nlive 100, 48 repeats), seeds "
          f"0-{b['seeds'] - 1}: logZ {[round(z, 4) for z in zs]}, mean {mean:.4f} (|mean| < "
          f"{b['bar']}: {ok}), evaluations {[r.n_like for r in runs]}, {wall:.2f} s  [{smi}]")
    if not ok:
        raise AssertionError(f"stepout battery: mean logZ {mean} outside {b['bar']} of 0")
    return {"mean_logz": mean, "logz": zs}


_RANK_LINE = re.compile(r"mcalf_torch rank (\d+) of (\d+) on (\S+): wall ([\d.]+) s, "
                        r"fused-kernel launches (\d+)")


def phase_distributed(tmp: Path, smi: str) -> dict:
    """Phase 14 (c): phase 6's flagship slice with ``[run] seeds =
    43,44,45,46`` through ``python -m torch.distributed.run --standalone
    --nproc_per_node 2 -m mcalf_torch``, both ranks on this one card, and
    through ``cli.main`` in this process: every chain file (the seeds'
    ``_s<seed>`` pairs and the merged one) byte for byte the same."""
    import os
    import signal

    dirs = {}
    for name in ("two", "one"):
        dirs[name] = d = tmp / f"dist_{name}"
        d.mkdir()
        _write_cfg(d / "fit.cfg", d, run=f"seeds = {','.join(map(str, DIST_SEEDS))}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "mcalf_torch", str(dirs["two"] / "fit.cfg")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"distributed: torchrun ran past {DIST_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"distributed: torchrun exited {proc.returncode}:\n{err[-3000:]}")
    ranks = {int(m.group(1)): m.groups() for m in _RANK_LINE.finditer(err)}
    if sorted(ranks) != [0, 1] or any(r[1] != "2" for r in ranks.values()):
        raise AssertionError(f"distributed: rank lines {ranks}:\n{err[-3000:]}")
    for r, (_, _, device, w, launches) in sorted(ranks.items()):
        if device != "cuda:0" or int(launches) == 0:
            raise AssertionError(f"distributed: rank {r} on {device} with {launches} fused launches")
    one = _drive_cli(dirs["one"] / "fit.cfg")
    if one["rc"] != 0:
        raise AssertionError(f"distributed: the one-process run returned {one['rc']}")
    names = sorted(p.relative_to(dirs["one"]) for p in dirs["one"].rglob("*")
                   if p.is_file() and p.name != "fit.cfg")
    stats = [n for n in names if n.suffix == ".stats"]
    if len(stats) != len(DIST_SEEDS) + 1 or not all(
            any(f"_s{s}" in n.name for n in stats) for s in DIST_SEEDS):
        raise AssertionError(f"distributed: files {names}")  # each seed's and the merged
    for rel in names:
        if (dirs["two"] / rel).read_bytes() != (dirs["one"] / rel).read_bytes():
            raise AssertionError(f"distributed: {rel} differs between two processes and one")
    walls = {r: float(v[3]) for r, v in ranks.items()}
    launches = [int(ranks[r][4]) for r in (0, 1)]
    print(
        f"[14 distributed] flagship slice, seeds {list(DIST_SEEDS)}: torchrun --nproc_per_node 2 "
        f"-m mcalf_torch, both ranks on cuda:0 (gloo), wall {wall:.2f} s (rank 0 "
        f"{walls[0]:.2f} s, rank 1 {walls[1]:.2f} s; fused launches {launches}); one process "
        f"(cli.main) {one['wall']:.2f} s, {one['launches']} fused launches; {len(names)} chain "
        f"files byte for byte the same  [{smi}]"
    )
    return {"launches": launches, "walls": [walls[0], walls[1]], "wall": wall,
            "one_wall": one["wall"], "one_launches": one["launches"]}


def phase_reference_style(smi: str) -> dict:
    """Phase 14 (d): ``ops.reference_style`` (the reference's formulation,
    plain PyTorch) against the fused kernel (``TorchForward.loglike``) on
    the same flagship rows at B = 100 and 200, log L to rtol 1e-5 / atol
    0.05 with the -inf pattern exact, and the call time of each (phase 5's
    CUDA events around single calls): the formulation ratio."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops.reference_style import make_reference_style_loglike

    model = _model("flagship")
    fwd = make_torch_forward(model, "cuda")
    ref = make_reference_style_loglike(model, "cuda")
    lo, hi = (np.asarray(b, np.float64) for b in zip(*model.bounds))
    out = {}
    for B in (100, 200):
        rng = np.random.default_rng(B)
        p = torch.from_numpy(
            (lo + rng.uniform(0.2, 0.8, size=(B, model.ndim)) * (hi - lo)).astype(np.float32)
        ).cuda()
        a, b = fwd.loglike(p).cpu().numpy(), ref(p).cpu().numpy()
        fin = np.isfinite(a)
        if not np.array_equal(fin, np.isfinite(b)):
            raise AssertionError(f"reference_style B={B}: the -inf pattern differs")
        err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
        if not np.allclose(a[fin], b[fin], rtol=1e-5, atol=0.05):
            raise AssertionError(f"reference_style B={B}: max |dlogL| {err} past rtol 1e-5, atol 0.05")
        t_ref = [_median_ms(lambda: ref(p), reps=10)]
        t_fused = [_median_ms(lambda: fwd.loglike(p)), _median_ms(lambda: fwd.loglike(p))]
        t_ref.append(_median_ms(lambda: ref(p), reps=10))
        ratio = float(np.mean(t_ref)) / float(np.mean(t_fused))
        out[B] = dict(ref_ms=float(np.mean(t_ref)), fused_call_ms=float(np.mean(t_fused)),
                      ratio=ratio, max_abs_err=err)
        print(
            f"[14 reference_style] flagship B={B}: max |dlogL| vs the fused kernel {err:.4g} "
            f"(rtol 1e-5, atol 0.05; |logL| up to {float(np.max(np.abs(a))):.4g}), finite {fin.sum()}"
            f"/{B}; call ms reference_style {t_ref[0]:.3f}/{t_ref[1]:.3f}, fused "
            f"(TorchForward.loglike) {t_fused[0]:.4f}/{t_fused[1]:.4f}: "
            f"{B / out[B]['fused_call_ms'] * 1e3:.4g} against {B / out[B]['ref_ms'] * 1e3:.4g} "
            f"evals/s, formulation ratio {ratio:.1f}x  [{smi}]"
        )
    return out


# ---- phase 15: stacked fleets outside 'same_edge', the calibration studies ----

#: phase 15 (a): total rows of the two stacked problems, interleaved at random
STACKED_TAU_B = (1, 13, 100, 1000)
#: the JAX package's full quadrature of testdata/civ_mock_spec.txt on the CPU
#: (jax 0.9.0, XLA likelihood): logZ and the (N, z, b) posterior mean and sd,
#: by ``JAX_PLATFORMS=cpu python tests/test_torch_truth_anchor.py 10,40``
#: (and ``3,40``), whose JAX_QUADRATURE holds the same numbers
JAX_QUADRATURE = {
    (10.0, 40.0): dict(
        logz=4985.520790475888,
        moments={"N": (13.799970399693077, 0.00302712920670298),
                 "z": (3.00000048025581, 9.473122215751973e-07),
                 "b": (14.918670666438624, 0.09293213593021848)}),
    (3.0, 40.0): dict(
        logz=4985.311086999623,
        moments={"N": (13.799970399726494, 0.0030271159062394597),
                 "z": (3.0000004802461393, 9.473072055341726e-07),
                 "b": (14.918672196773457, 0.09293110943311958)}),
}
#: phase 15 (c): the port's quadrature logZ within this of the JAX package's
QUADRATURE_BAR = 0.05
#: phase 15 (d): the JAX package's SBC test (tests/test_coverage.py)
SBC = dict(n_real=32, nlive=100, max_samples=6000)


def _tool(name):
    """A script of tools/ as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_stacked_tau(smi: str) -> dict:
    """Phase 15 (a): the tau kernel's problem axis.  Two problems stacked
    (the model and its shorter-range twin padded to its pixels), the rows
    of both interleaved at random, B rows in all: within the tau bar of the
    plain version, and every row bit for bit the single-problem launch's.
    Then the device time of one stacked launch of 2 x 200 rows against one
    launch of 400 rows of one problem, with its bound."""
    from mcalf_torch.ops import voigt_cuda

    worst, timing = 0.0, {}
    for name in ("flagship", "narrow", "mixed"):
        sf, _ = _stacked_pair(name)
        s = sf.static
        for B in STACKED_TAU_B:
            rng = np.random.default_rng(150 + B)
            u = _batch(s.ndim, B, False, seed=150 + B, layout=None)
            prob = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).cuda()
            targs = _tau_args(_stacked_args(sf, u, prob)[2])
            voigt_cuda.tau_launches = 0
            k = voigt_cuda.voigt_tau(*targs, prob=prob)
            q = voigt_cuda.voigt_tau_plain(*targs, prob=prob)
            torch.cuda.synchronize()
            if voigt_cuda.tau_launches != 1:
                raise AssertionError(f"stacked tau {name} B={B}: {voigt_cuda.tau_launches} launches")
            err = float(((k - q).abs() / (q.abs() + 1e-3)).max())
            if not err < 3e-5:
                raise AssertionError(f"stacked tau {name} B={B}: relative |dtau| {err}")
            for i in range(2):
                rows = (prob == i).nonzero().squeeze(1)
                if rows.numel() == 0:
                    continue
                one = voigt_cuda.voigt_tau(*(a[rows].contiguous() for a in targs[:4]),
                                           targs[4][i], targs[5][i], *targs[6:])
                if not torch.equal(k[rows], one):
                    raise AssertionError(f"stacked tau {name} B={B}: problem {i}'s rows are not "
                                         "the single-problem launch's")
            worst = max(worst, float((k - q).abs().max()))
            print(f"[15 stacked tau] {name} + {name}_short padded, T={s.ntrans} P={s.npix}, "
                  f"{B} rows of 2 problems interleaved in one launch "
                  f"({int((prob == 0).sum())} + {int((prob == 1).sum())}): relative |dtau| "
                  f"{err:.3g} vs plain, every row bit for bit the single-problem launch's")
        u = _batch(s.ndim, 400, False, seed=7, layout=None)
        prob = (torch.arange(400, device="cuda", dtype=torch.int32) % 2).contiguous()
        targs = _tau_args(_stacked_args(sf, u, prob)[2])
        single = tuple(targs[:4]) + (targs[4][0], targs[5][0]) + tuple(targs[6:])
        ms = [_device_ms(lambda: voigt_cuda.voigt_tau(*targs, prob=prob)),
              _device_ms(lambda: voigt_cuda.voigt_tau(*single))]
        ms.append(_device_ms(lambda: voigt_cuda.voigt_tau(*targs, prob=prob)))
        bound, by = _bound(targs, fused=False, prob=prob)
        timing[name] = dict(ms=(ms[0] + ms[2]) / 2, single_ms=ms[1], bound_ms=bound, bound_by=by)
        print(f"[15 stacked tau] {name}: one launch of 2 x 200 interleaved rows {ms[0]:.5f}, "
              f"{ms[2]:.5f} ms (device) against one 400-row launch of one problem "
              f"{ms[1]:.5f} ms; bound {bound:.5f} ms ({by})  [{smi}]")
    return {"max_abs_err": worst, "timing": timing}


def phase_wrap_fleet(tmp: Path, smi: str, fleet: dict, same_edge_profile: dict) -> dict:
    """Phase 15 (b): ``fit_many`` of phase 10's four flagship seeds with
    ``conv_mode='wrap'`` (the likelihood through ``voigt_tau`` with the
    problem axis, exp, the circular LSF and the chi^2 sum), captured, then
    the same fleet with the eager loop: members bit for bit and every
    member's chain files byte for byte the same, one tau launch per stacked
    likelihood call run and no fused launch in either.  Then one profiled
    outer step of the captured fleet (:func:`_profile_window`), its device
    time per iteration by class of kernel beside ``same_edge_profile``,
    phase 11's of the same fleet in ``'same_edge'``."""
    from mcalf_torch import runner
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import StackedForward, make_stacked_forward
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.parallel import fit_many
    from mcalf_torch.sampler import finalize, graph, init_state
    from mcalf_torch.sampler.nested import nested_sample_stacked, unstack_results
    from mcalf_torch.utils.profiling import count_launch

    cp, model, plan, cfg, device = _flagship_setup(tmp / "wrap_fleet")
    gp = model.gpriors is not None
    loglike_cube, calls = StackedForward.loglike_cube, []

    def counted(self, u, prob):  # a call counts when the card runs it
        count_launch(lambda n: calls.extend([1] * n))
        return loglike_cube(self, u, prob)

    def gens():
        return [torch.Generator(device=device).manual_seed(s) for s in FLEET_SEEDS]

    def captured():
        return [r.numpy() for r in unstack_results(fit_many(
            [model] * len(FLEET_SEEDS), cfg, mesh=[device], conv_mode="wrap", generators=gens(),
            gpriors=gp))]

    sf = make_stacked_forward(*stack_problems([model] * len(FLEET_SEEDS), conv_mode="wrap",
                                              gpriors=gp), device)

    def eager():
        return [finalize(f, cfg).numpy() for f in nested_sample_stacked(
            sf.loglike_cube, gens(), cfg, device, _loop="eager")]

    turns = {}
    StackedForward.loglike_cube = counted
    try:
        for name, run in (("captured", captured), ("eager", eager)):
            calls.clear()
            voigt_cuda.launches = voigt_cuda.tau_launches = 0
            graph.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            members = run()
            torch.cuda.synchronize()
            turns[name] = dict(members=members, wall=time.perf_counter() - t0, calls=len(calls),
                               tau=voigt_cuda.tau_launches, fused=voigt_cuda.launches,
                               graph=dict(graph.stats))
    finally:
        StackedForward.loglike_cube = loglike_cube
    for name, t in turns.items():
        if t["fused"] != 0 or t["tau"] != t["calls"] or t["calls"] < 2:
            raise AssertionError(f"wrap fleet {name}: {t['tau']} tau launches and {t['fused']} "
                                 f"fused launches for {t['calls']} stacked calls run")
        if (t["graph"]["captures"] > 0) != (name == "captured"):
            raise AssertionError(f"wrap fleet {name}: {t['graph']['captures']} graphs captured")
    fwd = make_torch_forward(model, device, conv_mode="wrap", gpriors=gp)
    for i, (a, b) in enumerate(zip(turns["captured"]["members"], turns["eager"]["members"])):
        if not (a.n_like == b.n_like and a.logz == b.logz and np.array_equal(a.samples_u, b.samples_u)
                and np.array_equal(a.logl, b.logl)):
            raise AssertionError(f"wrap fleet: seed {FLEET_SEEDS[i]} captured differs from eager")
        files = []
        for r in (a, b):
            base = runner._write_fit(cp, fwd, r, [("", r, cfg)], plan, cfg, [], False)
            files.append([Path(base + x).read_bytes() for x in (".stats", "_equal_weights.txt")])
        if files[0] != files[1]:
            raise AssertionError(f"wrap fleet: seed {FLEET_SEEDS[i]}'s captured files differ")
    out = {"members": turns["captured"]["members"]}
    for name, t in turns.items():
        iters = t["calls"] - 1  # the first call evaluates the four initial live sets
        n_like = sum(r.n_like for r in t["members"])
        out[name] = dict(launches=t["tau"], wall=t["wall"], ms_per_iter=t["wall"] / iters * 1e3,
                         n_like=n_like, replays=t["graph"]["replays"])
        print(f"[15 wrap fleet] fit_many conv_mode='wrap', seeds {list(FLEET_SEEDS)} of the "
              f"flagship slice, {name}: wall {t['wall']:.2f} s, {n_like} evaluations, {iters} "
              f"stacked iterations run ({t['graph']['replays']} replays), {t['tau']} voigt_tau "
              f"launches = stacked calls run, 0 fused, {t['wall'] / iters * 1e3:.4f} ms per "
              f"stacked iteration (phase 10 'same_edge': "
              f"{fleet['wall'] / fleet['iterations'] * 1e3:.4f} ms); logZ "
              f"{[round(float(r.logz), 3) for r in t['members']]}  [{smi}]")
    print("[15 wrap fleet] captured and eager members bit for bit, their .stats and "
          "_equal_weights.txt byte for byte")
    gens_ = gens()
    states = [init_state(fwd.loglike_cube, g, cfg, device) for g in gens_]
    w = _profile_window("wrap_fleet_captured", tmp / "traces", sf.loglike_cube, states, gens_,
                        cfg, None, kernel="voigt_tau_kernel")
    out["profile"] = w
    base = same_edge_profile["kernel_us_per_iter"]
    print(f"[15 wrap fleet] captured, one profiled outer step ({w['iterations']} slice iterations, "
          f"{w['kernel_events']} voigt_tau_kernel runs in the trace = the launches counted): "
          f"{w['launches_per_iter']:.2f} CUDA launches, {w['graph_launches_per_iter']:.4f} "
          f"cudaGraphLaunch and {w['syncs_per_iter']:.4f} syncs per iteration, "
          f"{w['device_us_per_iter']:.1f} us of device work (phase 11 'same_edge': "
          f"{same_edge_profile['device_us_per_iter']:.1f}) and {w['wall_ms_per_iter_profiled']:.4f} "
          f"ms of profiled wall per iteration (phase 11: "
          f"{same_edge_profile['wall_ms_per_iter_profiled']:.4f})  [{smi}]")
    print(f"[15 wrap fleet] device us per iteration by class, 'wrap': "
          f"{_rounded(w['kernel_us_per_iter'])}; 'same_edge' (phase 11): {_rounded(base)}")
    print(f"[15 wrap fleet] 'wrap' costliest kernels, us per iteration: "
          f"{_rounded(w['top_kernels_us_per_iter'])}")
    return out


def phase_quadrature(smi: str) -> dict:
    """Phase 15 (c): tools/torch_truth_anchor.py on the card, Harris
    (``brange = 10, 40``) and narrow (``3, 40``, the damped kernel): 22 M
    likelihood rows in batches of 16,384 through the fused kernel, logZ
    within QUADRATURE_BAR of the JAX package's on the same grid, one fused
    launch per batch; the moments beside the JAX package's; then the fused
    kernel at B = 16,384 against its plain version, on rows drawn from the
    whole coarse grid and on the fine grid's rows about the peak, and its
    device time on the latter, with its bound."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    ta = _tool("torch_truth_anchor")
    out = {}
    for brange, tag in (((10.0, 40.0), "harris"), ((3.0, 40.0), "narrow")):
        model = ta.make_model(brange=brange)
        fwd = make_torch_forward(model, "cuda")
        voigt_cuda.launches = 0
        t0 = time.perf_counter()
        res = ta.anchor(ta.torch_loglike(fwd), model.bounds_lo, model.bounds_hi,
                        log=lambda line: print(f"[15 quadrature] {tag}: {line}"))
        wall = time.perf_counter() - t0
        launches = voigt_cuda.launches
        batches = sum(-(-int(np.prod(g)) // ta.BATCH) for g in (ta.COARSE, ta.FINE))
        want = JAX_QUADRATURE[brange]
        d = res["logz"] - want["logz"]
        print(f"[15 quadrature] {tag} (brange {brange[0]:g}, {brange[1]:g}): logZ "
              f"{res['logz']:.4f} against the JAX package's {want['logz']:.4f} on the CPU "
              f"(d = {d:+.4f}, bar {QUADRATURE_BAR}); {res['rows']} rows in {launches} fused "
              f"launches of up to {ta.BATCH} rows, wall {wall:.2f} s (coarse "
              f"{res['wall_coarse_s']:.2f}, fine {res['wall_fine_s']:.2f}), "
              f"{res['rows'] / wall:.4g} rows/s, largest edge weight {res['edge']:.2e}  [{smi}]")
        for k in "Nzb":
            (mu, sd), (mu_j, sd_j) = res["moments"][k], want["moments"][k]
            print(f"[15 quadrature] {tag} posterior {k}: mean {mu:.8f} sd {sd:.8g} (JAX "
                  f"package, CPU: {mu_j:.8f}, {sd_j:.8g})")
        if launches != batches:
            raise AssertionError(f"quadrature {tag}: {launches} fused launches for {batches} batches")
        if not abs(d) < QUADRATURE_BAR:
            raise AssertionError(f"quadrature {tag}: logZ {res['logz']} is {d:+.4f} from "
                                 f"the JAX package's {want['logz']}")
        # the fused kernel at B = 16,384 against its plain version: rows of
        # the fine grid about the peak (then timed), and rows drawn from the
        # whole coarse grid, far from the peak too
        grids = ta.fine_grids(*(np.linspace(0, 1, n) for n in ta.COARSE),
                              [int(round(x * (n - 1))) for x, n in zip(res["peak_u"], ta.COARSE)])
        rows = ta.grid_rows(*grids)
        mid = rows.shape[0] // 2 - ta.BATCH // 2
        coarse = ta.grid_rows(*(np.linspace(0, 1, n) for n in ta.COARSE))
        pick = np.sort(np.random.default_rng(16384).choice(coarse.shape[0], ta.BATCH, replace=False))
        kw = dict(half=fwd.static.half, asymm=fwd.static.asymmlike)
        errs = {}
        for where, batch in (("coarse", coarse[pick]), ("peak", rows[mid:mid + ta.BATCH])):
            u = torch.from_numpy(batch).cuda()
            p, args = _fused_args(fwd, u)
            errs[where] = _fused_against_plain(f"quadrature {tag} {where}", p, fwd.consts(),
                                               fwd.static, args, kw)
        print(f"[15 quadrature] {tag}: fused kernel at B={ta.BATCH} against plain on the card, "
              f"{ta.BATCH} rows drawn from the coarse grid: {errs['coarse'][0]} finite, max "
              f"|dlogL| {errs['coarse'][1]:.3g}; the fine grid's {ta.BATCH} rows about the peak: "
              f"{errs['peak'][0]} finite, max |dlogL| {errs['peak'][1]:.3g} (chi2 within rtol "
              f"1e-5 / atol 0.1, n4/n5 equal, logL within rtol 1e-5 / atol 0.05, -inf exact)")
        ms = _device_ms(lambda: voigt_cuda.fused_loglike(*args, **kw))
        bound, by = _bound(args, fused=True, half=fwd.static.half)
        print(f"[15 quadrature] {tag}: fused kernel at B={ta.BATCH} (T={fwd.static.ntrans}, "
              f"P={fwd.static.npix}): device {ms:.5f} ms, bound {bound:.5f} ms ({by}), "
              f"{bound / ms:.1%} of it, {ms / ta.BATCH * 1e6:.3f} ns per row  [{smi}]")
        out[tag] = dict(logz=res["logz"], d_jax=d, moments=res["moments"], wall=wall,
                        launches=launches, ms=ms, bound_ms=bound, bound_by=by,
                        max_abs_err=max(e for _, e in errs.values()))
    return out


def _fused_against_plain(tag: str, p, c, s, args, kw) -> tuple:
    """The fused kernel and its plain version on the same card tensors:
    chi2 within rtol 1e-5 / atol 0.1, the asymmlike counts equal, the
    log-likelihood within rtol 1e-5 / atol 0.05 with the -inf pattern
    exact.  Returns (finite rows, the largest |dlogL|)."""
    from mcalf_torch.models import torch_model as tm
    from mcalf_torch.ops import voigt_cuda

    k = voigt_cuda.fused_loglike(*args, **kw)
    q = voigt_cuda.fused_loglike_plain(*args, **kw)
    ck, cq = (x[0].double().cpu().numpy() for x in (k, q))
    if not np.allclose(ck, cq, rtol=1e-5, atol=0.1):
        raise AssertionError(f"{tag}: max |dchi2| {np.max(np.abs(ck - cq))} vs plain")
    if not all(torch.equal(a, b) for a, b in zip(k[1:], q[1:])):
        raise AssertionError(f"{tag}: n4/n5 differ from plain")
    lk, lp = (tm.loglike_from_fused(p, c, s, *x).double().cpu().numpy() for x in (k, q))
    if not np.array_equal(np.isfinite(lk), np.isfinite(lp)):
        raise AssertionError(f"{tag}: -inf pattern differs from plain")
    fin = np.isfinite(lk)
    err = float(np.max(np.abs(lk[fin] - lp[fin]), initial=0.0))
    if not np.allclose(lk[fin], lp[fin], rtol=1e-5, atol=0.05):
        raise AssertionError(f"{tag}: max |dlogL| {err} vs plain")
    return int(fin.sum()), err


def phase_sbc(smi: str) -> dict:
    """Phase 15 (d): tools/torch_coverage_study.py at the JAX test's size
    (32 realizations, nlive 100, max_samples 6000) as one stacked fleet on
    the card, with the JAX test's gates: every fit converged, the truths'
    posterior ranks uniform (Bonferroni KS), 68%/95% coverage within
    binomial 3 sigma."""
    from mcalf_torch.ops import voigt_cuda
    from mcalf_torch.sampler import graph

    cov = _tool("torch_coverage_study")
    voigt_cuda.launches = 0
    graph.reset_stats()
    fit = {}
    out = cov.run_coverage(**SBC, fit_stats=fit)
    launches, g = voigt_cuda.launches, dict(graph.stats)
    print(f"[15 sbc] {SBC['n_real']} realizations (P={cov.NPIX}, T=2) as one fleet: wall "
          f"{fit['wall_s']:.2f} s, {fit['n_like']} evaluations, {launches} fused launches "
          f"({g['captures']} graphs, {g['replays']} replays), {fit['n_iter_max']} outer steps "
          f"at most; converged {out['converged_all']}, rank KS p {out['rank_ks_p']} (ok "
          f"{out['ranks_ok']}), coverage 68% {out['coverage']['0.68']['fraction_per_dim']} "
          f"95% {out['coverage']['0.95']['fraction_per_dim']} (tol "
          f"{out['coverage']['0.68']['binomial_3sigma_tol']}, "
          f"{out['coverage']['0.95']['binomial_3sigma_tol']})  [{smi}]")
    if not (out["converged_all"] and out["ranks_ok"]
            and all(out["coverage"][lvl]["ok"] for lvl in ("0.68", "0.95"))):
        raise AssertionError(f"sbc: a gate failed: {out}")
    if launches < 1:
        raise AssertionError("sbc: no fused launch")
    stacked = _time_q64(cov, smi)
    return dict(out, launches=launches, wall=fit["wall_s"], q64=stacked)


def _time_q64(cov, smi: str) -> dict:
    """The fused kernel at the SBC tool's default fleet, 64 realizations
    stacked (Q = 64, P = 300, T = 2): one launch of 100 rows of each,
    against the plain version (:func:`_fused_against_plain`), its device
    time and bound."""
    from mcalf_torch.models.batched import stack_problems
    from mcalf_torch.models.torch_model import make_stacked_forward
    from mcalf_torch.ops import voigt_cuda

    Q, B = 64, 100
    _, problems = cov.make_problems(Q, 20260819, 0.02)
    spec, stacked = stack_problems(problems)
    sf = make_stacked_forward(spec, stacked, "cuda")
    u = _batch(spec.ndim, Q * B, False, seed=Q, layout=None)
    prob = torch.arange(Q, device="cuda", dtype=torch.int32).repeat_interleave(B)
    p, c, args = _stacked_args(sf, u, prob)
    kw = dict(half=spec.half, asymm=spec.asymmlike, prob=prob)
    fin, err = _fused_against_plain(f"sbc Q={Q}", p, c, spec, args, kw)
    ms = _device_ms(lambda: voigt_cuda.fused_loglike(*args, **kw))
    bound, by = _bound(args, fused=True, half=spec.half, prob=prob)
    print(f"[15 sbc] fused kernel, one stacked launch of {Q} x {B} rows (Q={Q}, T={spec.ntrans}, "
          f"P={spec.npix}): against plain {fin} finite, max |dlogL| {err:.3g} (chi2 within rtol "
          f"1e-5 / atol 0.1, n4/n5 equal, logL within rtol 1e-5 / atol 0.05, -inf exact), device "
          f"{ms:.5f} ms, bound {bound:.5f} ms ({by}), {bound / ms:.1%} of it  [{smi}]")
    return dict(ms=ms, bound_ms=bound, bound_by=by, rows=Q * B, max_abs_err=err)


# ---- phase 16: the JAX package's last public names ----

#: phase 16's own budget of wall seconds (printed beside its wall)
PHASE16_BUDGET_S = 90.0
#: phase 16 (a): log L with the window off against on (tests/test_windowing.py)
WINDOW_LOGL_BAR = 3e-6
#: phase 16 (d): nested_sample_device on tests/test_torch_evidence_seeds.py's Gaussian
DEVICE_GAUSS = dict(ndim=4, sigma=0.08, nlive=100, num_delete=25, max_samples=8000)
DEVICE_SEEDS = tuple(range(8))


@contextlib.contextmanager
def _window_off():
    """``MCALF_TORCH_WINDOW=0`` inside the block: a forward model built
    there has every Harris transition in mode 0."""
    old = os.environ.get("MCALF_TORCH_WINDOW")
    os.environ["MCALF_TORCH_WINDOW"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MCALF_TORCH_WINDOW")
        else:
            os.environ["MCALF_TORCH_WINDOW"] = old


def phase_window_off(smi: str) -> dict:
    """Phase 16 (a): both kernels in mode 0 on the flagship against their
    plain versions, log L off against on, and mode 0's device time against
    mode 1's."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import voigt_cuda

    model = _model("flagship")
    with _window_off():
        off = make_torch_forward(model, "cuda")
    on = make_torch_forward(model, "cuda")
    s = off.static
    if off.modes.tolist() != [voigt_cuda.MODE_HARRIS] * s.ntrans or s.ntrans != 22:
        raise AssertionError(f"window off: mode table {off.modes.tolist()}")
    if set(on.modes.tolist()) != {voigt_cuda.MODE_WINDOWED}:
        raise AssertionError(f"window on: mode table {on.modes.tolist()}")
    kw = dict(half=s.half, asymm=s.asymmlike)
    worst = 0.0
    for B in (100, 37, 1):
        for clustered in (False, True):
            u = _batch(s.ndim, B, clustered, seed=B + 7 * clustered, layout=model.canon_layout())
            p, args = _fused_args(off, u)
            fin, err = _fused_against_plain(f"window off B={B}", p, off.consts(), s, args, kw)
            worst = max(worst, err)
            print(f"[16 window off] fused, modes [0] x {s.ntrans}, B={B} "
                  f"{'z-clustered' if clustered else 'spread'}: max |dlogL| {err:.3g} against "
                  f"plain, finite {fin}/{B}")
    worst_tau = 0.0
    for B in (100, 1000):
        targs = _tau_args(_fused_args(off, _batch(s.ndim, B, False, seed=3 * B, layout=None))[1])
        k = voigt_cuda.voigt_tau(*targs)
        q = voigt_cuda.voigt_tau_plain(*targs)
        rel = float(((k - q).abs() / (q.abs() + 1e-3)).max())
        if not rel < 3e-5:
            raise AssertionError(f"window off: tau B={B} max rel err {rel}")
        worst_tau = max(worst_tau, float((k - q).abs().max()))
        print(f"[16 window off] voigt_tau, modes [0] x {s.ntrans}, B={B}: max "
              f"|dtau|/(|tau|+1e-3) {rel:.3g} against plain")
    u = _batch(s.ndim, 64, False, seed=9, layout=None)
    l0 = off.loglike_cube(u).double().cpu().numpy()
    lw = on.loglike_cube(u).double().cpu().numpy()
    if not (np.isfinite(l0).all() and np.isfinite(lw).all()):
        raise AssertionError("window off/on: a log L is not finite")
    drel = float(np.max(np.abs(lw - l0) / (np.abs(l0) + 1.0)))
    if not drel < WINDOW_LOGL_BAR:
        raise AssertionError(f"window off/on: relative log-L difference {drel}")
    print(f"[16 window off] log L off against on, 64 rows: max relative difference {drel:.3g} "
          f"(bar {WINDOW_LOGL_BAR})")
    mode0 = {"fused": {}, "tau": {}}
    for B in (100, 200):
        u = _batch(s.ndim, B, False, seed=B, layout=None)
        a1, a0 = _fused_args(on, u)[1], _fused_args(off, u)[1]
        t1, t0 = _tau_args(a1), _tau_args(a0)
        f = lambda a: (lambda: voigt_cuda.fused_loglike(*a, **kw))
        t = lambda a: (lambda: voigt_cuda.voigt_tau(*a))
        # mode 1, mode 0, mode 0, mode 1
        fd = [_device_ms(f(a1)), _device_ms(f(a0)), _device_ms(f(a0)), _device_ms(f(a1))]
        td = [_device_ms(t(t1)), _device_ms(t(t0)), _device_ms(t(t0)), _device_ms(t(t1))]
        fp = _median_ms(lambda: voigt_cuda.fused_loglike_plain(*a0, **kw), reps=5)
        tp = _median_ms(lambda: voigt_cuda.voigt_tau_plain(*t0), reps=5)
        fb, fby = _bound(a0, True, s.half)
        tb, tby = _bound(t0, False)
        mode0["fused"][f"B={B}"] = dict(ms=(fd[1] + fd[2]) / 2, ms_mode1=(fd[0] + fd[3]) / 2,
                                        plain_ms=fp, bound_ms=fb, bound_by=fby)
        mode0["tau"][f"B={B}"] = dict(ms=(td[1] + td[2]) / 2, ms_mode1=(td[0] + td[3]) / 2,
                                      plain_ms=tp, bound_ms=tb, bound_by=tby)
        print(f"[16 window off] flagship B={B}, device ms mode 1 / 0 / 0 / 1: fused "
              f"{fd[0]:.5f} / {fd[1]:.5f} / {fd[2]:.5f} / {fd[3]:.5f} "
              f"({(fd[1] + fd[2]) / (fd[0] + fd[3]):.3f}x), plain {fp:.2f} ms, mode-0 bound "
              f"{fb:.5f} ms ({fby}); voigt_tau {td[0]:.5f} / {td[1]:.5f} / {td[2]:.5f} / "
              f"{td[3]:.5f} ({(td[1] + td[2]) / (td[0] + td[3]):.3f}x), plain {tp:.2f} ms, "
              f"mode-0 bound {tb:.5f} ms ({tby})  [{smi}]")
    return dict(max_abs_err=worst, max_abs_err_tau=worst_tau, logl_rel=drel, mode0=mode0)


def phase_window_off_slice(tmp: Path, smi: str, flagship: dict) -> dict:
    """Phase 16 (b): phase 6's flagship slice with the window off through
    ``cli.main``, in turns with the same slice windowed (windowed, off,
    off, windowed: phase 6's own wall holds the process's first-use costs
    of a fit, which later slices do not pay)."""
    from mcalf_torch import runner
    from mcalf_torch.config import readconfig
    from mcalf_torch.models.torch_model import line_modes, static_spec

    turns = []
    for i, off in enumerate((False, True, True, False)):
        out = tmp / f"window_turn{i}"
        out.mkdir()
        cfg = out / "fit.cfg"
        _write_cfg(cfg, out)
        with _window_off() if off else contextlib.nullcontext():
            modes = line_modes(static_spec(runner.build_model(readconfig(str(cfg)))))
            run = _drive_cli(cfg)
        if set(modes) != ({0} if off else {1}) or len(modes) != 22:
            raise AssertionError(f"window {'off' if off else 'on'} slice: mode table {modes}")
        if run["rc"] != 0 or len(run["fits"]) != 1:
            raise AssertionError(f"window slice turn {i}: cli.main returned {run['rc']}")
        res, base = run["fits"][0]
        logz, _, _ = _read_chain_pair(base, 2 + 34)
        if run["launches"] != run["batches"] or not math.isfinite(logz):
            raise AssertionError(f"window slice turn {i}: {run['launches']} fused launches for "
                                 f"{run['batches']} likelihood calls run, logZ {logz}")
        if not off:
            for suffix in (".stats", "_equal_weights.txt"):
                if Path(base + suffix).read_bytes() != Path(flagship["base"] + suffix).read_bytes():
                    raise AssertionError(f"windowed turn {i}: {suffix} differs from phase 6's")
        turns.append(dict(off=off, wall=run["wall"], rate=res.n_like / run["wall"],
                          launches=run["launches"], logz=logz, n_like=res.n_like))
    rate = lambda off: [t["rate"] for t in turns if t["off"] == off]
    r0, r1 = rate(True), rate(False)
    solo = flagship["n_like"] / flagship["wall"]
    walls = " / ".join(f"{t['wall']:.2f}" for t in turns)
    rates = " / ".join(f"{t['rate']:.4g}" for t in turns)
    print(f"[16 window off] flagship slice through cli.main, windowed / off / off / windowed: wall "
          f"{walls} s, {rates} evals/s ({sum(r0) / sum(r1):.3f}x off against on; phase 6, the process's first fit: "
          f"{solo:.4g}); modes [0] x 22 in the off turns, fused launches {turns[1]['launches']} = "
          f"likelihood calls run, n_like {turns[1]['n_like']}, logZ {turns[1]['logz']:.3f} (on: "
          f"{turns[0]['logz']:.3f}, files byte for byte phase 6's)  [{smi}]")
    return dict(launches=turns[1]["launches"], rate=sum(r0) / 2, windowed_rate=sum(r1) / 2,
                first_fit_rate=solo, walls=[t["wall"] for t in turns])


def phase_warmup(tmp: Path, smi: str, flagship: dict) -> dict:
    """Phase 16 (c): ``warmup_executables`` at the flagship's shapes, the
    first-use caches emptied before it, then phase 6's slice through
    ``cli.main``: it loads no library and computes no launch geometry, and
    its files are phase 6's byte for byte."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.ops import _build, voigt_cuda
    from mcalf_torch.sampler import graph, warmup_executables

    _, model, _, cfg, device = _flagship_setup(tmp / "warmup")
    caches = (_build.load, voigt_cuda._fused_fn, voigt_cuda._fused_cube_fn, voigt_cuda._tau_fn,
              voigt_cuda.fused_geometry, voigt_cuda.tau_geometry)
    for f in caches:
        f.cache_clear()
    voigt_cuda._DAMPED.clear()
    fwd = make_torch_forward(model, device, gpriors=model.gpriors is not None)
    gen = torch.Generator(device=device).manual_seed(43)
    start = gen.get_state()
    graph.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmup_executables(fwd.loglike_cube, gen, cfg, device)
    warm_s = time.perf_counter() - t0
    warm_capture_ms = graph.stats["capture_s"] * 1e3
    build_s = _build.load().build_seconds
    misses = [f.cache_info().misses for f in caches]
    if not torch.equal(gen.get_state(), start) or misses[0] != 1:
        raise AssertionError(f"warm-up: generator moved or {misses[0]} library loads")
    run = _drive_cli(tmp / "warmup" / "fit.cfg")
    after = [f.cache_info().misses for f in caches]
    if after != misses:
        raise AssertionError(f"warm-up: the slice after it missed the caches {misses} -> {after}")
    res, base = run["fits"][0]
    for suffix in (".stats", "_equal_weights.txt"):
        if Path(base + suffix).read_bytes() != Path(flagship["base"] + suffix).read_bytes():
            raise AssertionError(f"warm-up: the slice's {suffix} differs from phase 6's")
    capture_ms = run["graph"]["capture_s"] * 1e3
    share = capture_ms / 1e3 / run["wall"]
    print(f"[16 warm-up] warmup_executables at the flagship's shapes (ndim 34, nlive 200, B=100, "
          f"{cfg.resolved().num_repeats} repeats), caches emptied: {warm_s:.3f} s, of it the "
          f"kernel build {build_s:.3f} s (library on disk) and the graph capture "
          f"{warm_capture_ms:.1f} ms; then phase 6's slice through cli.main: {run['wall']:.2f} s, "
          f"no library load and no geometry after the warm-up (misses {after}), files byte for "
          f"byte phase 6's; its own graph capture {capture_ms:.1f} ms, {share:.2%} of its wall  "
          f"[{smi}]")
    return dict(warmup_s=warm_s, build_s=build_s, warmup_capture_ms=warm_capture_ms,
                slice_capture_ms=capture_ms, capture_share=share, slice_wall=run["wall"])


def phase_sampler_api(smi: str) -> dict:
    """Phase 16 (d): ``make_sampler`` against ``nested_sample`` on the
    flagship, and ``nested_sample_device`` on the Gaussian as one fleet
    against each seed's solo run."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.sampler import make_sampler, nested_sample, nested_sample_device
    from mcalf_torch.sampler.nested import NSConfig, _nested_sample_device_stacked, finalize

    tmp = ROOT / "build" / "chip_smoke" / "sampler_api"
    _, model, _, cfg, device = _flagship_setup(tmp)
    fwd = make_torch_forward(model, device, gpriors=model.gpriors is not None)
    t0 = time.perf_counter()
    a = make_sampler(fwd.loglike_cube, cfg)(torch.Generator(device=device).manual_seed(43))
    b = nested_sample(fwd.loglike_cube, torch.Generator(device=device).manual_seed(43), cfg, device)
    for k, x in a._asdict().items():
        y = getattr(b, k)
        if not (torch.equal(x, y) if torch.is_tensor(x) else x == y):
            raise AssertionError(f"make_sampler: {k} differs from nested_sample's")
    pair_s = time.perf_counter() - t0
    g = DEVICE_GAUSS
    norm = -0.5 * g["ndim"] * math.log(2 * math.pi * g["sigma"] ** 2)

    def gauss(u):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / g["sigma"] ** 2).to(torch.float32)

    gcfg = NSConfig(ndim=g["ndim"], nlive=g["nlive"], num_delete=g["num_delete"],
                    max_samples=g["max_samples"])
    t0 = time.perf_counter()
    finals = _nested_sample_device_stacked(
        lambda u, prob: gauss(u), [torch.Generator(device=device).manual_seed(s) for s in DEVICE_SEEDS],
        gcfg, device)
    fleet = [finalize(f, gcfg).numpy() for f in finals]
    fleet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s, m in zip(DEVICE_SEEDS, fleet):
        one = nested_sample_device(gauss, torch.Generator(device=device).manual_seed(s), gcfg,
                                   device).numpy()
        if not (m.logz == one.logz and m.n_like == one.n_like
                and np.array_equal(m.samples_u, one.samples_u)):
            raise AssertionError(f"nested_sample_device: seed {s}'s fleet member differs from its "
                                 f"solo run ({m.logz} against {one.logz})")
    solo_s = time.perf_counter() - t0
    logz = np.array([float(m.logz) for m in fleet])
    sem = float(logz.std(ddof=1) / math.sqrt(len(logz)))
    bar = max(3.0 * sem, 0.08)
    print(f"[16 sampler api] make_sampler(...)(gen) byte for byte nested_sample on the flagship "
          f"slice, seed 43 ({pair_s:.2f} s for both); nested_sample_device on the Gaussian (ndim "
          f"{g['ndim']}, sigma {g['sigma']}, nlive {g['nlive']}): {len(DEVICE_SEEDS)} seeds as one "
          f"fleet {fleet_s:.2f} s, each member its solo run bit for bit (solo runs {solo_s:.2f} s); "
          f"mean logZ {logz.mean():+.4f} (sem {sem:.4f}, bar {bar:.4f}), steps "
          f"{[int(m.n_iter) for m in fleet]}  [{smi}]")
    if not abs(logz.mean()) < bar:
        raise AssertionError(f"nested_sample_device: mean logZ {logz.mean()} outside {bar}")
    return dict(mean_logz=float(logz.mean()), sem=sem, fleet_s=fleet_s)


def phase_wrap_solo(smi: str, wrap: dict) -> dict:
    """Phase 16 (e): each member of phase 15 (b)'s captured ``'wrap'``
    fleet (four flagship seeds) against its solo captured run: bit for
    bit, or the size of the difference in the error."""
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.sampler import nested_sample

    _, model, _, cfg, device = _flagship_setup(ROOT / "build" / "chip_smoke" / "wrap_solo")
    fwd = make_torch_forward(model, device, conv_mode="wrap", gpriors=model.gpriors is not None)
    t0 = time.perf_counter()
    for s, m in zip(FLEET_SEEDS, wrap["members"]):
        one = nested_sample(fwd.loglike_cube, torch.Generator(device=device).manual_seed(s), cfg,
                            device).numpy()
        same = (m.n_like == one.n_like and m.logz == one.logz
                and np.array_equal(m.samples_u, one.samples_u) and np.array_equal(m.logl, one.logl))
        if not same:
            n = min(len(m.logl), len(one.logl))
            d = np.abs(m.logl[:n].astype(np.float64) - one.logl[:n])
            raise AssertionError(
                f"wrap: seed {s}'s fleet member differs from its solo run: n_like {m.n_like} / "
                f"{one.n_like}, logZ {m.logz} / {one.logz}, {int(np.sum(d[np.isfinite(d)] > 0))} "
                f"log L differ, the largest by {np.max(d[np.isfinite(d)], initial=0.0)}")
    wall = time.perf_counter() - t0
    print(f"[16 wrap solo] conv_mode='wrap': each of seeds {list(FLEET_SEEDS)} of phase 15 (b)'s "
          f"captured fleet bit for bit its solo captured run (n_like, logZ, samples, log L); "
          f"the four solo runs {wall:.2f} s  [{smi}]")
    return dict(members_are_solo=True, wall=wall)


# ---- phase 17: the slice kernels against the torch ops ----

#: phase 17: the flagship's chains a problem, parameters and passes
SLICE_CHECK_B, SLICE_CHECK_NDIM, SLICE_CHECK_PASSES = 100, 34, 816
#: phase 17: iterations compared in a row; the loop reaches its cap at the last four
SLICE_CHECK_ITERATIONS = 16


def _slice_loop(Q: int, seed: int, table_ll: bool):
    """A chord slice loop on the card at phase 17's widths: (fixed inputs,
    carry, the likelihood's state).  Its pool holds sub-1e-12 entries,
    signed zeros, axis directions and NaN directions (a failed Cholesky
    factor), its points lie on the cube's faces at random, and a third of
    the directions are axis directions with the bracket's low end at the
    face (r = 0 then proposes a point on it).  With ``table_ll`` the
    likelihood reads log L from one of four (Q, B) tables, the one
    ``state["k"]`` names, with values at the constraint and -inf, and keeps
    the rows it was handed in ``state["seen"]``; else it returns one fixed
    table and launches nothing."""
    from mcalf_torch.sampler import NSConfig
    from mcalf_torch.sampler import nested as tn

    dev = torch.device("cuda")
    B, ndim, nrep = SLICE_CHECK_B, SLICE_CHECK_NDIM, SLICE_CHECK_PASSES
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    cfg = NSConfig(ndim=ndim, nlive=2 * B, num_delete=B, num_repeats=nrep).resolved()
    n = torch.randn((Q, nrep, B, ndim), generator=g, device=dev)
    pools = 0.3 * n / n.norm(dim=-1, keepdim=True)
    for val in (1e-13, -1e-13, 0.0, -0.0):
        pools = torch.where(rand(*pools.shape) < 0.02, val, pools)
    eye = torch.eye(ndim, device=dev)
    axis = rand(Q, nrep, B) < 0.15
    pools[axis] = eye[torch.randint(0, ndim, (int(axis.sum()),), generator=g, device=dev)]
    pools[rand(Q, nrep, B) < 0.03] = float("nan")
    lstar = -0.5 + 0.2 * torch.randn((Q, 1), generator=g, device=dev)
    tables = torch.randn((4, Q, B), generator=g, device=dev)
    pick = rand(4, Q, B)
    tables = torch.where(pick < 0.15, lstar.expand(4, Q, B), tables)
    tables = torch.where((pick >= 0.15) & (pick < 0.25), -math.inf, tables)
    state = {"k": 0, "seen": []}
    if table_ll:
        def loglike_rows(u, prob):
            state["seen"].append(u.clone())
            return tables[state["k"]].reshape(-1)
    else:
        flat = tables[0].reshape(-1).contiguous()

        def loglike_rows(u, prob):
            return flat
    gens = [torch.Generator(device=dev).manual_seed(seed + 1 + q) for q in range(Q)]
    x = tn._fixed(loglike_rows, gens, pools, lstar.reshape(Q), list(range(Q)), cfg)
    x = x._replace(active=torch.zeros((Q, B), dtype=torch.int64, device=dev))
    u = rand(Q, B, ndim)
    u = torch.where(rand(Q, B, ndim) < 0.05, 0.0, u)
    u = torch.where(rand(Q, B, ndim) < 0.05, 1.0, u)
    c = tn._init_loop_carry(u, torch.randn((Q, B), generator=g, device=dev), x)
    k = torch.randint(0, ndim, (Q, B), generator=g, device=dev)
    face = rand(Q, B) < 0.3
    c.d.copy_(torch.where(face[..., None], eye[k], c.d))
    lo, hi = tn._bracket(c.u, c.d)
    c.lo.copy_(torch.where(face, 0.0 - torch.gather(c.u, 2, k[..., None])[..., 0], lo))
    c.hi.copy_(hi)
    c.it_pass.copy_(torch.randint(0, x.max_shrink, (Q, B), generator=g, device=dev,
                                  dtype=torch.int32))
    passes = torch.randint(0, nrep + 1, (Q, B), generator=g, device=dev, dtype=torch.int32)
    if Q > 1:
        passes[Q - 1] = nrep  # a problem with every pass made
    c.passes.copy_(passes)
    c.it_total.fill_(x.total_cap - SLICE_CHECK_ITERATIONS + 4)
    return x, c, state


def _same_tensor(a: torch.Tensor, b: torch.Tensor, by_value: bool) -> bool:
    """Bit for bit (``by_value``: -0 == +0), a NaN matching a NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    a, b = a[~na], b[~nb]
    return torch.equal(a, b) if by_value else torch.equal(a.view(torch.int32), b.view(torch.int32))


def _slice_bytes(Q: int) -> int:
    """Bytes the two slice kernels move in one iteration where every chain
    accepts and starts a pass: slice_propose reads u, d and writes u_eval;
    slice_update reads u, d and the pool's row and writes u and d; per row
    the bracket, draw, passes, flags, t, log L and the active count."""
    rows = Q * SLICE_CHECK_B
    return 4 * rows * SLICE_CHECK_NDIM * 8 + rows * 76


def phase_slice_kernels(smi: str) -> dict:
    """Phase 17: the slice kernels against ``_slice_step_ops`` on the same
    carry, then both timed (see the module's docstring)."""
    from mcalf_torch.ops import slice_cuda
    from mcalf_torch.sampler import nested as tn

    out = {}
    for Q in (1, FLEET_Q):
        x, c, state = _slice_loop(Q, 1700 + Q, table_ll=True)
        B = c.logl.shape[1]
        slice_cuda.launches = 0
        moved = 0
        for it in range(SLICE_CHECK_ITERATIONS):
            for q in range(Q):
                torch.rand((B,), generator=x.gens[q], device=c.u.device, out=x.r[q])
            state["k"] = it % 4
            c_ops, act_ops = type(c)(*(t.clone() for t in c)), x.active.clone()
            state["seen"].clear()
            tn._slice_step_ops(c_ops, x._replace(active=act_ops))
            seen_ops = state["seen"][:]
            state["seen"].clear()
            before = c.u.clone()
            tn._slice_step(c, x)
            torch.cuda.synchronize()
            for name, a, b in zip(c._fields, c, c_ops):
                if not _same_tensor(a, b, by_value=name in ("lo", "hi")):
                    raise AssertionError(f"[17] Q={Q} iteration {it}: the kernels' {name} "
                                         "differs from the torch ops'")
            if not torch.equal(x.active, act_ops):
                raise AssertionError(f"[17] Q={Q} iteration {it}: the active rows differ")
            if not (len(state["seen"]) == len(seen_ops) == 1
                    and _same_tensor(state["seen"][0], seen_ops[0], by_value=False)):
                raise AssertionError(f"[17] Q={Q} iteration {it}: the rows handed to the "
                                     "likelihood differ")
            moved += int((c.u != before).any(dim=-1).sum())
        launches = slice_cuda.launches
        if launches != SLICE_CHECK_ITERATIONS or int(c.it_total) != x.total_cap + 4:
            raise AssertionError(f"[17] Q={Q}: {launches} slice_update launches, it_total "
                                 f"{int(c.it_total)}, for {SLICE_CHECK_ITERATIONS} iterations")

        # one iteration's bookkeeping, with a likelihood that launches nothing
        xk, ck, _ = _slice_loop(Q, 1800 + Q, table_ll=False)
        xo, co, _ = _slice_loop(Q, 1800 + Q, table_ll=False)
        ck.it_total.zero_()
        co.it_total.zero_()

        def kernels():
            tn._slice_step(ck, xk)

        def ops():
            tn._slice_step_ops(co, xo)

        rec = dict(rows=Q * B, check_launches=launches, moved_rows=moved)
        rec["ms"], rec["plain_device_ms"] = _device_ms(kernels), _device_ms(ops)
        rec["call_ms"], rec["plain_ms"] = _median_ms(kernels), _median_ms(ops)
        rec["propose_ms"] = _profiled_ms(kernels, "slice_propose")
        rec["update_ms"] = _profiled_ms(kernels, "slice_update")
        rec["bytes"] = _slice_bytes(Q)
        rec["bound_ms"], rec["bound_by"] = rec["bytes"] / PEAK_BYTES * 1e3, "bytes"
        out[f"Q={Q}"] = rec
        print(f"[17 slice kernels] Q={Q} x B={B}, ndim {SLICE_CHECK_NDIM}, {SLICE_CHECK_PASSES} "
              f"passes: {SLICE_CHECK_ITERATIONS} iterations (the last 4 past the cap), "
              f"{moved} row moves, every carry tensor, n_like, it_total, the active rows and "
              f"the likelihood's rows bit for bit the torch ops' (the bracket ends by value); "
              f"slice_update launches {launches}; bookkeeping an iteration: kernels "
              f"{rec['ms'] * 1e3:.2f} us device (slice_propose {_us(rec['propose_ms'])}, "
              f"slice_update {_us(rec['update_ms'])}), {rec['call_ms'] * 1e3:.2f} us a call; "
              f"torch ops {rec['plain_device_ms'] * 1e3:.2f} us device, "
              f"{rec['plain_ms'] * 1e3:.2f} us a call; bound {rec['bound_ms'] * 1e3:.3f} us "
              f"({rec['bytes']} bytes)  [{smi}]")
    return out


def _us(ms) -> str:
    return "not in the trace" if ms is None else f"{ms * 1e3:.2f} us"


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    regs = phase_build()
    worst, worst_cube = phase_kernel_check()
    worst_ragged = phase_ragged_check()
    worst_stacked, worst_cube_stacked = phase_stacked_check()
    worst_tau = phase_tau_check()
    timing = phase_timing(smi)
    tmp = ROOT / "build" / "chip_smoke"  # git-ignored
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        flagship = phase_slice(tmp, "flagship")
        narrow = phase_slice(tmp, "narrow", brange="3.0, 40.0")
        tau_path = phase_tau_path(narrow["posterior"])
        phase_anchor([10.0, 40.0], QUADRATURE_LOGZ, "1-comp")
        phase_anchor([3.0, 40.0], NARROW_LOGZ, "1-comp narrow")
        launches_variants = phase_variants(tmp, smi)
        fleet = phase_fleet(tmp, smi, flagship)
        loops = phase_loops(tmp, smi, flagship, fleet)
        plot = phase_plot(tmp, smi)
        hi = phase_hi_forest(tmp, smi)
        stepout = phase_stepout(tmp, smi, flagship)
        battery = phase_stepout_battery(smi)
        dist = phase_distributed(tmp, smi)
        refstyle = phase_reference_style(smi)
        stacked_tau = phase_stacked_tau(smi)
        wrap = phase_wrap_fleet(tmp, smi, fleet, loops["fleet"]["profile_captured"])
        quad = phase_quadrature(smi)
        sbc = phase_sbc(smi)
        t16 = time.perf_counter()
        window = phase_window_off(smi)
        window_slice = phase_window_off_slice(tmp, smi, flagship)
        warmup = phase_warmup(tmp, smi, flagship)
        phase_sampler_api(smi)
        wrap_solo = phase_wrap_solo(smi, wrap)
        wall16 = time.perf_counter() - t16
        print(f"[16 total] phase 16 wall {wall16:.1f} s of its {PHASE16_BUDGET_S:.0f} s budget  "
              f"[{smi}]")
        slice_kernels = phase_slice_kernels(smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_start
    print(f"[total] chip_smoke.py wall {wall:.1f} s of its 1200 s  [{smi}]")
    if wall >= 1200:
        raise AssertionError(f"chip_smoke.py took {wall:.1f} s, over its 1200 s")
    imported = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mcalf_tpu"))
    if imported:
        raise AssertionError(f"the port imported {imported[:5]}")
    f_ms, f_call, f_plain, f_bound, f_by = timing["narrow", 100]["fused"]
    t_ms, t_call, t_plain, t_bound, t_by = timing["narrow", 100]["tau"]
    at = "narrow flagship (fit.cfg, brange 3-40), T=22 P=1999 B=100"
    print(json.dumps({"kernels": [
        {
            "name": "fused_loglike",
            "route": "cuda",
            "source": "mcalf_torch/csrc/fused_loglike.cu",
            "replaces": "mcalf_tpu/ops/voigt_pallas.py:150 and :213",
            "launches": narrow["launches"],
            "launches_flagship_slice": flagship["launches"],
            "launches_phase9": launches_variants,
            "launches_fleet": fleet["launches"],
            "launches_plot": plot["fused_launches"],
            "launches_hi_forest": hi["launches"],
            # phase 14: the step-out slice captured and eager, and the two
            # processes of the torchrun fleet (each rank's own count)
            "launches_stepout": stepout["launches"],
            "launches_stepout_eager": stepout["launches_eager"],
            "launches_distributed": dist["launches"],
            "stepout_evals_ratio_to_chord": stepout["n_like"] / stepout["chord_n_like"],
            "stepout_battery_mean_logz": battery["mean_logz"],
            "distributed_rank_walls_s": dist["walls"],
            # reference_style (plain PyTorch, the reference's formulation)
            # against this kernel's call at the flagship
            "reference_style": {f"B={B}": r for B, r in refstyle.items()},
            "max_abs_err_hi_forest": hi["max_abs_err"],
            # phase 15 (c): the quadrature's batches of 16,384 rows, and the
            # kernel's device time at that B; (d): the SBC fleet of 32
            "launches_quadrature": {k: v["launches"] for k, v in quad.items()},
            "quadrature_logz": {k: v["logz"] for k, v in quad.items()},
            "B16384": {k: {m: v[m] for m in ("ms", "bound_ms", "bound_by", "max_abs_err")}
                       for k, v in quad.items()},
            "launches_sbc": sbc["launches"],
            "Q64": sbc["q64"],
            # phase 16: mode 0 (MCALF_TORCH_WINDOW=0) on the flagship, its
            # slice, and the warm-up
            "mode0": window["mode0"]["fused"],
            "max_abs_err_mode0": window["max_abs_err"],
            "launches_window_off_slice": window_slice["launches"],
            "window_off_slice_evals_per_s": window_slice["rate"],
            "windowed_slice_evals_per_s": window_slice["windowed_rate"],
            "warmup": {k: warmup[k] for k in ("warmup_s", "build_s", "warmup_capture_ms",
                                              "slice_capture_ms", "capture_share")},
            "max_abs_err": worst,
            "max_abs_dchi2_ragged": worst_ragged,
            "max_abs_err_stacked": worst_stacked,
            "ms": f_ms,
            "call_ms": f_call,
            "plain_ms": f_plain,
            "bound_ms": f_bound,
            "bound_by": f_by,
            # the port's own FLOP census of the plain version (phase 5)
            "census_bound_ms": {m: timing[m, 100]["census"]["fused"][1] for m in ("flagship", "narrow")},
            "hi_forest_evals_per_s": hi["n_like"] / hi["wall"],
            "library_ms": None,
            "at": at,
            "registers": regs,
            # the sampler's launch from unit-cube rows (phases 3 and 5)
            "cube": _cube_entry(timing, worst_cube, worst_cube_stacked),
            # one launch of 4 x 100 flagship rows against four B=100 launches
            "stacked": timing["stacked"],
            "fleet_evals_per_s": fleet["rate"],
            "solo_slice_evals_per_s": fleet["solo_rate"],
            # phase 11: the captured slice loop against the eager one
            "loops": {name: {k: v for k, v in rec.items() if not k.startswith("profile")}
                      for name, rec in loops.items()},
            "loop_profiles": {f"{name} {k[8:]}": {m: rec[k][m] for m in (
                "launches_per_iter", "graph_launches_per_iter", "syncs_per_iter", "busy_share")}
                for name, rec in loops.items() for k in rec if k.startswith("profile")},
        },
        {
            "name": "slice_propose+slice_update",
            "route": "cuda",
            "source": "mcalf_torch/csrc/slice_step.cu",
            "replaces": "the torch ops of mcalf_torch/sampler/nested.py::_slice_step_ops "
                        "(no TPU kernel: XLA fuses the JAX package's slice loop body)",
            # phase 6: one slice_update launch per slice iteration of each
            # slice, counted from 0 by the main path's own run; phase 10:
            # per stacked iteration of the fleet
            "launches": flagship["slice_launches"],
            "launches_narrow_slice": narrow["slice_launches"],
            "launches_fleet": fleet["slice_launches"],
            # phase 17: against the torch ops, and one iteration's
            # bookkeeping timed (ms device, call_ms, plain_ms a call of the
            # torch ops, bound_ms the bytes at the peak) at Q problems of 100
            **{k: v for k, v in slice_kernels[f"Q={FLEET_Q}"].items()},
            "Q1": slice_kernels["Q=1"],
            "max_abs_err": 0.0,
            "library_ms": None,
            "at": f"{FLEET_Q} x {SLICE_CHECK_B} chains, ndim {SLICE_CHECK_NDIM}",
        },
        {
            "name": "voigt_tau",
            "route": "cuda",
            "source": "mcalf_torch/csrc/voigt_tau.cu",
            "replaces": "mcalf_tpu/ops/voigt_pallas.py:132",
            "launches": tau_path["launches"],
            "launches_plot": plot["launches"],
            "launches_hi_forest": hi["tau_launches"],
            # phase 15 (b): the 'wrap' fleet, one launch per stacked call
            "launches_wrap_fleet": wrap["captured"]["launches"],
            "launches_wrap_fleet_eager": wrap["eager"]["launches"],
            # phase 16 (e): every 'wrap' member its solo run bit for bit
            "wrap_members_are_solo": wrap_solo["members_are_solo"],
            # phase 16 (a): mode 0 on the flagship
            "mode0": window["mode0"]["tau"],
            "max_abs_err_mode0": window["max_abs_err_tau"],
            "wrap_fleet_ms_per_iter": {k: wrap[k]["ms_per_iter"] for k in ("captured", "eager")},
            "wrap_fleet_device_us_per_iter": wrap["profile"]["kernel_us_per_iter"],
            "max_abs_err": worst_tau,
            # phase 15 (a): the problem axis, and one 2 x 200-row launch
            "max_abs_err_stacked": stacked_tau["max_abs_err"],
            "stacked": stacked_tau["timing"],
            "max_abs_dflux_plot": plot["max_abs_err"],
            "max_abs_dflux_hi_forest": hi["max_abs_dflux"],
            "ms": t_ms,
            "call_ms": t_call,
            "plain_ms": t_plain,
            "bound_ms": t_bound,
            "bound_by": t_by,
            "census_bound_ms": {m: timing[m, 100]["census"]["tau"][1] for m in ("flagship", "narrow")},
            "library_ms": None,
            "at": at,
            # device ms (mean of two), call ms and bound ms per model and batch
            "by_batch": {f"{k[0]} B={k[1]}": [round(v, 5) for v in (r["tau"][0], r["tau"][1], r["tau"][3])]
                         for k, r in timing.items() if isinstance(k, tuple)},
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
