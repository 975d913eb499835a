"""End to end through ``python -m mcalf_torch`` on the CPU: config file ->
fit -> chain files in the JAX CLI's layout, without jax in the process; and
each of the runner's other fits once (tests/test_torch_runner_variants.py
checks them in depth)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch import runner
from mcalf_torch.cli import main

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"


CFG = """
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = jaxns
specres = 8.0

[pathing]
datadir = {testdata}/
outdir = {out}/
chainfmt = pc_fits_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
{run}

[jaxns_settings]
max_samples = 600
num_live_points = 50

[ns_settings]
num_repeats = 4
{extra}
"""


def _write_cfg(tmp_path, run="device = cpu", extra=""):
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(CFG.format(testdata=TESTDATA, out=tmp_path, run=run, extra=extra))
    return cfg


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_e2e")
    rc = main([str(_write_cfg(out)), "--debug"])
    assert rc == 0
    return out


def test_cli_writes_chain_files_in_jax_layout(cli_outputs):
    fits = cli_outputs / "fits"
    stats = (fits / "pc_fits_0.stats").read_text().splitlines()
    # the JAX CLI's .stats: the log(Z) line, then '#' comment lines
    head = stats[0].split()
    assert head[0] == "log(Z)" and head[1] == ":" and head[3] == "+/-"
    assert np.isfinite(float(head[2])) and float(head[4]) > 0
    assert stats[1].startswith("# insertion-rank KS p = ")
    eq = np.loadtxt(fits / "pc_fits_0_equal_weights.txt", ndmin=2)
    ndim = 4
    assert eq.shape == (600, 2 + ndim)
    assert np.all(eq[:, 0] == 1.0)
    # physical parameters inside the prior box [ncomp, N, z, b]
    assert np.all((eq[:, 2] == 1.0) & (eq[:, 3] >= 12.0) & (eq[:, 3] <= 14.5))
    assert np.all((eq[:, 4] >= 2.99) & (eq[:, 4] <= 3.01))
    assert np.all(np.isfinite(eq[:, 1]))


def test_cli_chain_files_parse_with_jax_readers(cli_outputs):
    from mcalf_tpu.io.chains import read_equal_weights, read_stats

    lnz, err = read_stats(str(cli_outputs / "fits" / "pc_fits_0.stats"))
    assert np.isfinite(lnz) and err > 0
    m = read_equal_weights(str(cli_outputs / "fits" / "pc_fits_0_equal_weights.txt"))
    assert m.shape[1] == 6


def test_port_runs_without_jax(tmp_path):
    """Importing the port and running a tiny fit never imports jax."""
    cfg = _write_cfg(tmp_path, extra="max_samples = 150")
    code = textwrap.dedent(f"""
        import sys
        import mcalf_torch, mcalf_torch.runner, mcalf_torch.cli
        from mcalf_torch.cli import main
        assert main([{str(cfg)!r}]) == 0
        assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
        print('NOJAX-OK')
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout


def test_narrow_line_fit_through_python_m(tmp_path):
    """The narrow-line 1-comp CIV fit (brange = 3, 40: both transitions
    strongly damped, every evaluation in the full hjert) through
    ``python -m mcalf_torch`` on the CPU, at reduced depth."""
    cfg = tmp_path / "narrow.cfg"
    cfg.write_text(
        CFG.format(testdata=TESTDATA, out=tmp_path, run="device = cpu", extra="")
        .replace("brange = 10.0, 40.0", "brange = 3.0, 40.0")
        .replace("max_samples = 600", "max_samples = 300")
        .replace("num_live_points = 50", "num_live_points = 40")
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "mcalf_torch", str(cfg)], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    head = (tmp_path / "fits" / "pc_fits_0.stats").read_text().split()
    assert head[0] == "log(Z)" and np.isfinite(float(head[2])) and float(head[4]) > 0
    eq = np.loadtxt(tmp_path / "fits" / "pc_fits_0_equal_weights.txt", ndmin=2)
    assert eq.shape == (300, 2 + 4) and np.all(np.isfinite(eq))
    assert np.all((eq[:, 5] >= 3.0) & (eq[:, 5] <= 40.0))


def test_device_default_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = _write_cfg(tmp_path, run="device = default")
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(cfg)])
    # the [run] device default is 'default'
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.resolve_device({})


@pytest.mark.parametrize(
    "extra_run,extra_ns,match",
    [
        ("seeds = 1,2", "", "seeds"),
        ("ncomp_grid = True", "", "ncomp_grid"),
        ("checkpoint = ckpt", "", "checkpoint"),
        ("", "dynamic = True", "dynamic"),
        ("", "auto_repeats = True", "auto_repeats"),
    ],
)
def test_unported_branches_raise(tmp_path, monkeypatch, capsys, extra_run, extra_ns, match):
    """The runner's branches that used to raise NotImplementedError (the
    test keeps its name): each now runs through the CLI and leaves its own
    files beside the chain pair.  tests/test_torch_runner_variants.py checks
    the branches in depth."""
    monkeypatch.chdir(tmp_path)  # `checkpoint = ckpt` is relative to the cwd
    # cut at the cap, but for the boost pass, which needs a posterior
    extra_ns = f"max_samples = {1200 if match == 'dynamic' else 300}\n" + extra_ns
    cfg = _write_cfg(tmp_path, run="device = cpu\n" + extra_run, extra=extra_ns)
    assert main([str(cfg)]) == 0
    fits = tmp_path / "fits"
    head = (fits / "pc_fits_0.stats").read_text()
    assert head.startswith("log(Z)   : ")
    assert np.isfinite(np.loadtxt(fits / "pc_fits_0_equal_weights.txt", ndmin=2)).all()
    own = {
        "seeds": [fits / "pc_fits_0_s1.stats", fits / "pc_fits_0_s2_equal_weights.txt"],
        "ncomp_grid": [fits / "pc_fits_0_ncomp_grid.txt", fits / "pc_fits_0_k1.stats"],
        "checkpoint": list((tmp_path / "ckpt").glob("ns_state_*.npz"))[:1] or [tmp_path / "none"],
        "dynamic": [],
        "auto_repeats": [],
    }[match]
    assert all(p.exists() for p in own), own
    marks = {
        "seeds": "# merged 2 seeds [1, 2] by birth contours",
        "ncomp_grid": "# insertion-rank KS p",
        "checkpoint": "# insertion-rank KS p",
        "dynamic": "# boost insertion-rank KS p",
        "auto_repeats": "# auto_repeats ladder converged=",
    }
    assert marks[match] in head


def test_pc_settings_resume_not_ported(tmp_path, capsys):
    """Formerly the NotImplementedError of a [pc_settings] section (the test
    keeps its name): a bare section switches PolyChord's resume machinery
    and the dead-birth file on, and the fit runs and resumes."""
    from mcalf_tpu.config import readconfig

    cp = readconfig(str(_write_cfg(tmp_path)))
    cp["solver"] = "polychord"
    cp["pc_settings"] = {"nlive": "50"}
    cp["ns_settings"] = dict(cp["ns_settings"], max_samples="300")
    res, base = runner.run_fit(cp)
    assert np.isfinite(res.logz) and base == str(tmp_path / "fits" / "pc_fits_0")
    assert list((tmp_path / "fits" / "pc_fits_0_resume").glob("ns_state_*.npz"))
    assert np.loadtxt(base + "_dead-birth.txt").shape[1] == 4 + 2
    capsys.readouterr()
    again, _ = runner.run_fit(cp)
    assert "Resuming from checkpoint" in capsys.readouterr().out
    assert again.logz == res.logz and again.n_like == res.n_like
