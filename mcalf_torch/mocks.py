"""Mock-spectrum generator: builds mock spectra from the fitter's own
forward model, so mocks and model share one code path.

A copy of :mod:`mcalf_tpu.mocks` (host numpy, float64) on the port's
:class:`~mcalf_torch.models.AbsorptionModel` and atomic table; the port
imports nothing of the JAX package.  tests/test_torch_mocks.py holds every
array and file equal to the original's, byte for byte.

Generates the two CIV fixtures -- a 1-component doublet and a 10-component
blend -- on a log-uniform grid, plus a runnable fit config; and an HI
Lyman-alpha forest fixture with a contaminating metal line and its
filler-based fit config (hi_forest.cfg).  Noise is seed-42 N(0, 0.02)
(seed 7 for the HI forest), and the multicomponent spectrum is the
*product of individually convolved* single-component spectra, as the
reference generator builds it.

Usage: ``python -m mcalf_torch.mocks [outdir]`` (regenerates ``testdata/``
by default).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mcalf_torch.atomic import get_lines
from mcalf_torch.models.forward import CLIGHT_KMS, AbsorptionModel

# 10-component truth (reference generate_from_model.py:12-14).
Z_TRUE = [2.999, 2.9995, 3.0, 3.001, 3.0005, 3.0015, 3.002, 3.0025, 3.0035, 3.0039]
N_TRUE = [13.6, 13.0, 13.8, 13.6, 13.2, 13.4, 13.5, 14.0, 14.2, 13.7]
B_TRUE = [17.5, 8.0, 20.0, 25.0, 15.0, 30.0, 10.0, 25.0, 15.0, 20.0]

# Single-component truth (recovered from civ_mock_spec.txt, BASELINE.md).
SINGLE_TRUTH = dict(N=13.8, z=3.0, b=15.0)

FWHM_KMS = 8.0
NOISE_SIGMA = 0.02  # SNR = 50
NOISE_SEED = 42

# HI Lyman-alpha forest workload (BASELINE.md config #4; the benchmark's
# secondary workload and tests/test_hi_forest.py): two HI components at
# z ~ 2.5 plus an unidentified contaminating metal line (CIV 1548 from
# another redshift) that the FILLER machinery must absorb.
HI_WREST = 1215.67
HI_TRUTH = [(13.6, 2.4975, 25.0), (13.2, 2.4995, 18.0)]  # (logN, z, b)
HI_CONTAM = dict(line="CIV 1548", obs_wave=4259.0, N=13.4, b=12.0)
HI_VELSTEP_KMS = 2.0
HI_WMIN, HI_NPIX = 4251.0, 400
HI_NOISE_SEED = 7


def log_uniform_grid(wmin=6180.0, wmax=6220.0, velstep_kms=0.96755464):
    """Log-uniform wavelength grid at constant velocity step."""
    step = 1.0 + velstep_kms / CLIGHT_KMS
    n = int(np.floor(np.log(wmax / wmin) / np.log(step))) + 1
    return wmin * step ** np.arange(n)


def _model_on_grid(wave):
    return AbsorptionModel(
        wave=wave,
        flux=np.ones_like(wave),
        noise=np.full_like(wave, NOISE_SIGMA),
        lines=get_lines(["CIV 1548", "CIV 1550"]),
        ncomp=(1, 1),
        specres=[FWHM_KMS],
    )


def generate_single(wave=None):
    """Noiseless 1-component CIV doublet + seed-42 noisy realization."""
    wave = log_uniform_grid() if wave is None else wave
    m = _model_on_grid(wave)
    p = np.array([1.0, SINGLE_TRUTH["N"], SINGLE_TRUTH["z"], SINGLE_TRUTH["b"]])
    noiseless = m.reconstruct_spec(p)
    rng = np.random.RandomState(NOISE_SEED)
    noisy = noiseless + rng.normal(0, NOISE_SIGMA, size=wave.size)
    return wave, noiseless, noisy


def generate_multicomp(wave=None):
    """Product of individually convolved single-component spectra (the
    reference generator's construction) + seed-42 noise."""
    wave = log_uniform_grid() if wave is None else wave
    m = _model_on_grid(wave)
    flux = np.ones_like(wave)
    for N, z, b in zip(N_TRUE, Z_TRUE, B_TRUE):
        flux = flux * m.reconstruct_spec(np.array([1.0, N, z, b]))
    rng = np.random.RandomState(NOISE_SEED)
    noisy = flux + rng.normal(0, NOISE_SIGMA, size=wave.size)
    return wave, flux, noisy


def generate_hi_forest(wave=None):
    """HI forest mock: two HI Lya components times a CIV contaminant from
    an unrelated redshift, + seed-7 noise (the benchmark's secondary
    workload).  Returns (wave, noiseless, noisy)."""
    if wave is None:
        step = 1.0 + HI_VELSTEP_KMS / CLIGHT_KMS
        wave = HI_WMIN * step ** np.arange(HI_NPIX)
    n = wave.size
    gen = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, NOISE_SIGMA),
        lines=get_lines(["HI 1215"]), ncomp=(2, 2), specres=[FWHM_KMS],
    )
    p = np.array([2.0] + [v for t in HI_TRUTH for v in t])
    flux = gen.reconstruct_spec(p)
    civ = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, NOISE_SIGMA),
        lines=get_lines([HI_CONTAM["line"]]), ncomp=(1, 1),
        specres=[FWHM_KMS],
    )
    zciv = HI_CONTAM["obs_wave"] / 1548.204 - 1.0
    flux = flux * civ.reconstruct_spec(
        np.array([1.0, HI_CONTAM["N"], zciv, HI_CONTAM["b"]])
    )
    rng = np.random.RandomState(HI_NOISE_SEED)
    noisy = flux + rng.normal(0, NOISE_SIGMA, size=n)
    return wave, flux, noisy


#: observed wavelengths of the HI forest's three absorbers: the two HI Lya
#: components and the contaminant
HI_FEATURES = tuple((1.0 + z) * HI_WREST for _, z, _ in HI_TRUTH) + (HI_CONTAM["obs_wave"],)


def hi_forest_config(dest, datadir, run_lines: str = "") -> str:
    """Write ``<datadir>/hi_forest.cfg`` (the shipped fit) to
    ``<dest>/hi.cfg`` with its paths pointed at ``datadir`` and ``dest``
    and ``run_lines`` added to its ``[run]`` section; returns the path."""
    with open(os.path.join(datadir, "hi_forest.cfg")) as f:
        text = f.read()
    text = text.replace("datadir = testdata/", f"datadir = {datadir}/")
    text = text.replace("outdir = testdata/output/", f"outdir = {dest}/")
    if run_lines:
        text = text.replace("[run]\n", f"[run]\n{run_lines}\n")
    os.makedirs(dest, exist_ok=True)
    path = os.path.join(dest, "hi.cfg")
    with open(path, "w") as f:
        f.write(text)
    return path


def hi_absorbers(post, model: AbsorptionModel):
    """The HI forest's reading of a z-sorted posterior of ``model``
    (physical parameters, one filler): its MAP ncomp, the sorted observed
    wavelengths of the three absorbers (the medians of the two active HI
    components over the ncomp = 2 rows, and of the filler), and, over those
    rows, the share with the filler nearest each of :data:`HI_FEATURES`
    (which absorber the filler models is not identified by the data)."""
    post = np.asarray(post, np.float64)
    nact = np.floor(post[:, model.startind]).astype(int)
    vals, counts = np.unique(nact, return_counts=True)
    two = post[nact == 2]
    if not len(two):
        return int(vals[np.argmax(counts)]), [float("nan")] * 3, [float("nan")] * 3
    comps = [float(np.median((1.0 + two[:, model.startind + 2 + 3 * i]) * HI_WREST))
             for i in range(2)]
    fill = float(np.median((1.0 + post[:, model.endind + 1]) * model.linefill.wrest))
    wfill = (1.0 + two[:, model.endind + 1]) * model.linefill.wrest
    near = np.argmin(np.abs(wfill[:, None] - np.asarray(HI_FEATURES)[None, :]), axis=1)
    share = [float(np.mean(near == i)) for i in range(3)]
    return int(vals[np.argmax(counts)]), sorted(comps + [fill]), share


def _write(path, wave, flux):
    err = np.full_like(wave, NOISE_SIGMA)
    np.savetxt(path, np.column_stack([wave, flux, err]), header="Wave Flux Err")


FIT_CFG = """# Flagship fit: trans-dimensional multicomponent CIV doublet.
[input]
specfile = civ_mock_spec_multicomp.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = jaxns
specres = 8.0
asymmlike = False

[pathing]
datadir = {outdir}/
outdir = {outdir}/output/
chainfmt = pc_fits_{{0}}

[components]
ncomp = 8,11
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = True
showprogress = False

[jaxns_settings]
# NOTE: the reference ships max_samples = 2000, which caps this 34-dim fit
# long before the evidence converges (the sampler warns).  40000 converges.
max_samples = 40000
num_live_points = 200
difficult_model = True
"""


HI_CFG = """# HI Lyman-alpha forest fit with a filler nuisance line: the data
# contain an unidentified contaminating absorber (a metal line from another
# redshift); ncomp selects the HI component count by evidence while the
# filler absorbs the contaminant (the reference's nfill machinery,
# hires_fitter.py:120-121,151-166).  Truth: 2 HI components + 1 contaminant.
[input]
specfile = hi_forest_mock.txt
wavefit = 4251,4262
linelist = HI 1215
coldef = Wave, Flux, Err
solver = ns
specres = 8.0

[pathing]
datadir = {outdir}/
outdir = {outdir}/output/
chainfmt = hi_fits_{{0}}

[components]
ncomp = 1,3
nfill = 1
contval = 1
Nrange = 12.5,14.5
brange = 10.0, 40.0
zrange = {zlo:.6f}, {zhi:.6f}
Nrangefill = 12.5,15.0
brangefill = 5.0,30.0
wrangefill = 4253,4262

[run]
dofit = True
doplot = True
showprogress = False

[ns_settings]
nlive = 100
max_samples = 8000
precision_criterion = 0.05
"""


def main(outdir: str = "testdata") -> None:
    os.makedirs(outdir, exist_ok=True)
    wave, _, noisy1 = generate_single()
    _write(os.path.join(outdir, "civ_mock_spec.txt"), wave, noisy1)
    wave, _, noisym = generate_multicomp(wave)
    _write(os.path.join(outdir, "civ_mock_spec_multicomp.txt"), wave, noisym)
    with open(os.path.join(outdir, "fit.cfg"), "w") as f:
        f.write(FIT_CFG.format(outdir=outdir))
    hwave, _, hnoisy = generate_hi_forest()
    _write(os.path.join(outdir, "hi_forest_mock.txt"), hwave, hnoisy)
    with open(os.path.join(outdir, "hi_forest.cfg"), "w") as f:
        f.write(
            HI_CFG.format(
                outdir=outdir,
                zlo=HI_WMIN / HI_WREST - 1.0,
                zhi=float(hwave[-1]) / HI_WREST - 1.0,
            )
        )
    print(f"Wrote mocks + fit.cfg + hi_forest.cfg to {outdir}/")


if __name__ == "__main__":
    main(*sys.argv[1:2])
