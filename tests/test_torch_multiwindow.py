"""A two-window fit through ``python -m mcalf_torch``: the twin of
tests/test_multiwindow.py at its settings and bars.  The CIV doublet at
z = 3 is split across two ``wavefit`` ranges -- 1548 at 6192.8 A in the
first, 1550 at 6203.1 A in the second -- so the likelihood combines
disjoint pixel sets and the plot panels per window.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mcalf_torch.analysis import analyze_chains
from mcalf_torch.io.chains import read_stats
from mcalf_torch.models import AbsorptionModel, make_torch_forward

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"

CFG = """
[input]
specfile = civ_mock_spec.txt
wavefit = 6188,6197,6199,6208
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata}/
outdir = {out}/
chainfmt = mw_{{0}}

[components]
ncomp = 1,1
contval = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = True
device = cpu

[pc_settings]
nlive = 60
precision_criterion = 0.01
read_resume = False
write_resume = False
write_dead = False

[ns_settings]
max_samples = 2500

[plots]
nmaxcols = 5
"""


def _cli(cfg):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "mcalf_torch", str(cfg)], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def multiwindow_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mw")
    cfg = out / "fit.cfg"
    cfg.write_text(CFG.format(testdata=TESTDATA, out=out))
    proc = _cli(cfg)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


def test_forward_model_masks_two_windows():
    m = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), fitrange=[(6188.0, 6197.0), (6199.0, 6208.0)],
        fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 1), specres=[8.0], zrange=[2.99, 3.01],
    )
    assert m.numfitranges == 2 and m.npix == m.obj_wl.size < m.wave.size
    # the port's forward model at the generative truth fits both windows
    fwd = make_torch_forward(m, device="cpu")
    import torch

    spec = fwd.reconstruct(torch.tensor([[1.0, 13.8, 3.0, 15.0]])).numpy()[0]
    resid = (m.obj - spec) / m.obj_noise
    for lo, hi in ((6188.0, 6197.0), (6199.0, 6208.0)):
        sel = (m.obj_wl >= lo) & (m.obj_wl <= hi)
        assert np.abs(resid[sel]).mean() < 1.5, (lo, hi)


def test_multiwindow_fit_recovers_truth(multiwindow_outputs):
    out = multiwindow_outputs
    lnz, err = read_stats(str(out / "fits" / "mw_0.stats"))
    assert np.isfinite(lnz) and 0 < err < 1.5
    _, _, _, post = analyze_chains(str(out / "fits" / "mw_0"))
    # Layout: [ncomp, N, z, b]; truth N=13.8, z=3.0, b=15.  Both windows
    # constrain z jointly through the doublet ratio.
    assert abs(np.nanmedian(post[:, 1]) - 13.8) < 0.08
    assert abs(np.nanmedian(post[:, 2]) - 3.0) < 1.5e-4
    assert abs(np.nanmedian(post[:, 3]) - 15.0) < 2.0


def test_multiwindow_plot_panels(multiwindow_outputs):
    pytest.importorskip("matplotlib")
    out = multiwindow_outputs
    assert (out / "plots" / "mw_0.pdf").exists()
    # the multi-row branch (numfitranges > nmaxcols): re-plot the same
    # chains with nmaxcols = 1, plot only
    cfg2 = out / "plot_only.cfg"
    cfg2.write_text((out / "fit.cfg").read_text().replace("dofit = True", "dofit = False")
                    .replace("nmaxcols = 5", "nmaxcols = 1"))
    os.remove(out / "plots" / "mw_0.pdf")
    proc = _cli(cfg2)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (out / "plots" / "mw_0.pdf").exists()
