"""mcalf_torch.mocks against mcalf_tpu.mocks: the same generator (host
numpy, float64) on the port's own forward model and atomic table.

Exact throughout: every generated array bit for bit, the constants and
config templates equal, and ``main`` writes the three shipped spectra of
testdata/ byte for byte and both configs as the JAX package's ``main``
writes them.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mcalf_tpu import mocks as jmocks
from mcalf_torch import mocks as tmocks

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"
SPECTRA = ("civ_mock_spec.txt", "civ_mock_spec_multicomp.txt", "hi_forest_mock.txt")


@pytest.mark.parametrize("name", ("generate_single", "generate_multicomp", "generate_hi_forest"))
def test_generated_arrays_bit_for_bit(name):
    want = getattr(jmocks, name)()
    got = getattr(tmocks, name)()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


def test_generators_on_a_given_grid():
    wave = tmocks.log_uniform_grid(6190.0, 6200.0, 1.5)
    np.testing.assert_array_equal(wave, jmocks.log_uniform_grid(6190.0, 6200.0, 1.5))
    for name in ("generate_single", "generate_multicomp", "generate_hi_forest"):
        for g, w in zip(getattr(tmocks, name)(wave), getattr(jmocks, name)(wave)):
            np.testing.assert_array_equal(g, w)


def test_constants_and_config_templates_equal():
    names = [n for n in vars(jmocks) if n.isupper()]
    assert {"FIT_CFG", "HI_CFG", "Z_TRUE", "HI_TRUTH", "NOISE_SEED"} <= set(names)
    for n in names:
        assert getattr(tmocks, n) == getattr(jmocks, n), n


def test_main_reproduces_testdata(tmp_path, capsys):
    out = tmp_path / "torch"
    tmocks.main(str(out))
    assert capsys.readouterr().out == f"Wrote mocks + fit.cfg + hi_forest.cfg to {out}/\n"
    for name in SPECTRA:
        assert (out / name).read_bytes() == (TESTDATA / name).read_bytes(), name
    jout = tmp_path / "jax"
    jmocks.main(str(jout))
    for name in ("fit.cfg", "hi_forest.cfg"):
        assert (out / name).read_text() == (jout / name).read_text().replace(str(jout), str(out))
    # the shipped configs differ from a generated one only in their paths
    for name in ("fit.cfg", "hi_forest.cfg"):
        assert (out / name).read_text().replace(str(out), "testdata") == (TESTDATA / name).read_text()


def test_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "mcalf_torch.mocks", str(tmp_path)],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "hi_forest_mock.txt").read_bytes() == (TESTDATA / "hi_forest_mock.txt").read_bytes()


def test_hi_features_are_the_truth_wavelengths():
    """The three absorbers tests/test_hi_forest.py places: the two HI Lya
    components at their true redshifts and the contaminant."""
    assert tmocks.HI_FEATURES == ((1 + 2.4975) * 1215.67, (1 + 2.4995) * 1215.67, 4259.0)
    assert tmocks.HI_FEATURES[:2] == tuple((1.0 + z) * jmocks.HI_WREST for _, z, _ in jmocks.HI_TRUTH)


def test_hi_forest_config_is_the_shipped_one_repointed(tmp_path):
    """hi_forest_config changes the shipped config's two path lines and adds
    the given lines to [run]; every other line stays."""
    from mcalf_torch.config import readconfig

    path = tmocks.hi_forest_config(str(tmp_path / "out"), str(TESTDATA), "seeds = 3,5\ndevice = cpu")
    assert path == str(tmp_path / "out" / "hi.cfg")
    got = Path(path).read_text().splitlines()
    shipped = (TESTDATA / "hi_forest.cfg").read_text().splitlines()
    assert [ln for ln in got if ln not in ("seeds = 3,5", "device = cpu")] == [
        f"datadir = {TESTDATA}/" if ln == "datadir = testdata/" else
        f"outdir = {tmp_path / 'out'}/" if ln == "outdir = testdata/output/" else ln
        for ln in shipped
    ]
    cp = readconfig(path)
    assert cp["seeds"] == [3, 5] and cp["device"] == "cpu"
    assert cp["ns_settings"] == {"nlive": "100", "max_samples": "8000", "precision_criterion": "0.05"}


def test_hi_absorbers_reading(tmp_path):
    """MAP ncomp, the absorbers' sorted wavelengths from the ncomp = 2 rows'
    component medians and every row's filler, and the filler's share on
    each feature, for a posterior built to hold them."""
    from mcalf_torch.config import readconfig
    from mcalf_torch.runner import build_model

    model = build_model(readconfig(tmocks.hi_forest_config(str(tmp_path), str(TESTDATA))))
    rng = np.random.default_rng(3)
    n = 400
    post = np.full((n, model.ndim), np.nan)
    post[:, 0] = np.where(np.arange(n) < 300, 2.0, 1.0)
    zs = [z for _, z, _ in tmocks.HI_TRUTH]
    for i, z in enumerate(zs):
        post[:, model.startind + 2 + 3 * i] = z + rng.normal(0.0, 1e-6, n)
    wf = model.linefill.wrest
    zfill = np.where(np.arange(n) % 4 == 0, tmocks.HI_FEATURES[1], tmocks.HI_FEATURES[2]) / wf - 1.0
    post[:, model.endind + 1] = zfill
    mapn, wobs, share = tmocks.hi_absorbers(post, model)
    assert mapn == 2
    np.testing.assert_allclose(wobs, tmocks.HI_FEATURES, atol=0.01)
    assert share == [0.0, 0.25, 0.75]
