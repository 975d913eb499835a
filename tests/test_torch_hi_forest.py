"""HI Lyman-alpha forest fit with a filler nuisance line, on the port: twin
of tests/test_hi_forest.py with its bars.  An HI mock with a contaminating
CIV line is fit with HI components plus one filler; the posterior must
hold exactly three absorbers at the three features, two of them HI
(MAP ncomp 2).  Then testdata/hi_forest.cfg, with its sampler settings
reduced, runs through ``python -m mcalf_torch`` (fit, banner and PDF).
Both on the CPU.

Slow, as the JAX module is (full fits to convergence): outside the
``-m 'not slow'`` tier.
"""

import configparser
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.analysis import analyze_chains, ncomp_occurrence, sort_components
from mcalf_torch.atomic import get_lines
from mcalf_torch.mocks import HI_FEATURES, hi_absorbers
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.models.forward import CLIGHT_KMS
from mcalf_torch.sampler import NSConfig, nested_sample, resample_equal

pytestmark = pytest.mark.slow

REPO = Path(__file__).parents[1]


@pytest.fixture(scope="module")
def hi_mock():
    # Log-uniform grid around Lya at z~2.5: 4251-4262 A.
    velstep = 2.0
    step = 1.0 + velstep / CLIGHT_KMS
    n = 400
    wave = 4251.0 * step ** np.arange(n)
    gen = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, 0.02),
        lines=get_lines(["HI 1215"]), ncomp=(2, 2), specres=[8.0],
    )
    truth = [(13.6, 2.4975, 25.0), (13.2, 2.4995, 18.0)]
    flux = gen.reconstruct_spec(np.array([2.0] + [v for t in truth for v in t]))
    civ = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, 0.02),
        lines=get_lines(["CIV 1548"]), ncomp=(1, 1), specres=[8.0],
    )
    zciv = 4259.0 / 1548.204 - 1.0
    flux = flux * civ.reconstruct_spec(np.array([1.0, 13.4, zciv, 12.0]))
    rng = np.random.RandomState(7)
    return wave, flux + rng.normal(0, 0.02, n)


def test_hi_fit_with_filler_absorbs_contaminant(hi_mock):
    wave, flux = hi_mock
    m = AbsorptionModel(
        wave=wave, flux=flux, noise=np.full(wave.size, 0.02),
        lines=get_lines(["HI 1215"]),
        ncomp=(1, 3), nfill=1,
        specres=[8.0],
        Nrange=[12.5, 14.5], brange=[10.0, 40.0],
        zrange=[(4251.0 / 1215.67 - 1), (4262.0 / 1215.67 - 1)],
        Nrangefill=[12.5, 15.0], brangefill=[5.0, 30.0],
    )
    assert m.ndim == 1 + 3 * 3 + 3
    fwd = make_torch_forward(m, "cpu")
    cfg = NSConfig(ndim=m.ndim, nlive=100, max_samples=8000, precision_criterion=0.05)
    res = nested_sample(fwd.loglike_cube, torch.Generator().manual_seed(11), cfg, "cpu").numpy()
    assert int(res.termination_reason) == 0
    su, _ = resample_equal(torch.Generator().manual_seed(42), res, 2000)
    p = fwd.cube_to_params(torch.from_numpy(su)).numpy().astype(np.float64)

    # Which absorber models which feature is not identified by the data (a
    # single Lya transition carries no doublet information); what the data
    # constrain is three absorbers at the three features, two of them HI.
    vals, frac, mapn = ncomp_occurrence(p, m.startind)
    assert mapn == 2, dict(zip(vals.tolist(), frac.tolist()))
    _, absorbers, _ = hi_absorbers(sort_components(p, m.startind, nfill=m.nfill), m)
    for want, got in zip(HI_FEATURES, absorbers):
        assert abs(got - want) < 0.5, (HI_FEATURES, absorbers)


def test_hi_forest_config_reduced_end_to_end(tmp_path):
    """testdata/hi_forest.cfg through ``python -m mcalf_torch`` on the CPU
    at reduced sampler settings: fit, analysis, banner and PDF, recovering
    the 2-component MAP (nlive, max_samples and precision reduced as in the
    JAX twin; num_repeats too, which the JAX twin keeps at its calibrated
    312).  The shipped settings run on the card, in chip_smoke.py."""
    testdata = REPO / "testdata"
    cp = configparser.ConfigParser()
    assert cp.read(testdata / "hi_forest.cfg")
    cp["pathing"]["datadir"] = str(testdata) + os.sep
    cp["pathing"]["outdir"] = str(tmp_path) + os.sep
    cp["run"]["device"] = "cpu"
    cp["ns_settings"]["nlive"] = "60"
    cp["ns_settings"]["max_samples"] = "6000"
    cp["ns_settings"]["precision_criterion"] = "0.2"
    # the CPU's eager slice loop at the calibrated 24*ndim = 312 repeats
    # takes most of an hour here; 4*ndim keeps the 2-component MAP
    cp["ns_settings"]["num_repeats"] = "52"
    cfg = tmp_path / "hi.cfg"
    with open(cfg, "w") as f:
        cp.write(f)
    proc = subprocess.run(
        [sys.executable, "-m", "mcalf_torch", str(cfg)], cwd=str(REPO),
        capture_output=True, text=True, timeout=3000,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    banner = proc.stdout
    # never-active component columns are all-NaN after z-sorting; the
    # chi2 at the medians must still be finite
    assert "Chi2:    nan" not in banner and "Chi2:" in banner
    base = str(tmp_path / "fits" / "hi_fits_1")
    lnz, lnz_err, _lhood, post = analyze_chains(base)
    assert np.isfinite(lnz) and lnz_err > 0
    nact = np.floor(post[:, 0]).astype(int)
    vals, counts = np.unique(nact, return_counts=True)
    assert vals[np.argmax(counts)] == 2, dict(zip(vals, counts))
    assert (tmp_path / "plots" / "hi_fits_1.pdf").is_file()
    assert f"PDF written at: {tmp_path}/plots/hi_fits_1.pdf" in banner
