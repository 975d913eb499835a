"""The port's own copies of the JAX package's host modules (config parser,
atomic table, spectrum and chain IO) against the originals, and the port's
import boundary: no module of mcalf_torch imports mcalf_tpu or jax.

Everything here is exact: the copies run the same host code in float64
(spectra) or text (config, chain files), so values, dicts and bytes are
equal.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import mcalf_torch
from mcalf_tpu import config as jconfig
from mcalf_tpu.io import chains as jchains
from mcalf_tpu.io import spectra as jspectra
from mcalf_torch import atomic as tatomic
from mcalf_torch import config as tconfig
from mcalf_torch.io import chains as tchains
from mcalf_torch.io import spectra as tspectra

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (
            isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
            and a.dtype == b.dtype and np.array_equal(a, b)
        )
    return type(a) is type(b) and a == b


@pytest.mark.parametrize(
    "cfg", ("testdata/fit.cfg", "testdata/hi_forest.cfg", "examples/ensemble_fit.cfg")
)
def test_readconfig_matches_jax(cfg, monkeypatch):
    monkeypatch.chdir(REPO)  # the configs' datadir is relative to the repo
    want = jconfig.readconfig(cfg)
    got = tconfig.readconfig(cfg)
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k


def _fresh_table(path):
    """A module's line table as its source defines it, untouched by any
    register_line call another test made in this process."""
    name = f"_fresh_{abs(hash(path))}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[name]
    return mod._LINES


def test_atomic_tables_match_jax():
    want = _fresh_table(REPO / "mcalf_tpu" / "atomic" / "data.py")
    got = _fresh_table(REPO / "mcalf_torch" / "atomic" / "data.py")
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert (g.name, g.wrest, g.f, g.gamma) == (w.name, w.wrest, w.f, w.gamma), name


def test_atomic_registry_is_the_ports_own(tmp_path):
    from mcalf_tpu import atomic as jatomic

    atomfile = tmp_path / "extra.dat"
    atomfile.write_text("# ion label wrest f gamma\nTORCHONLY 1000 1000.5 0.1 1e8\n")
    try:
        assert tatomic.load_atomfile(str(atomfile)) == 1
        assert tatomic.get_line("TORCHONLY 1000").wrest == 1000.5
        with pytest.raises(jatomic.LineNotFoundError):
            jatomic.get_line("TORCHONLY 1000")
    finally:
        tatomic.data._LINES.pop("TORCHONLY 1000", None)


def _spectrum_files(tmp_path):
    files = [TESTDATA / n for n in
             ("civ_mock_spec.txt", "civ_mock_spec_multicomp.txt", "hi_forest_mock.txt")]
    rng = np.random.default_rng(3)
    m = np.column_stack([np.linspace(4000, 4010, 50), rng.uniform(0, 1, (50, 2))])
    bare = tmp_path / "bare_header.txt"
    np.savetxt(bare, m, header="Wave Flux Err", comments="")
    none = tmp_path / "no_header.txt"
    np.savetxt(none, m)
    return files + [bare, none]


def test_load_spectrum_matches_jax(tmp_path):
    for path in _spectrum_files(tmp_path):
        want = jspectra.read_spectrum_table(str(path))
        got = tspectra.read_spectrum_table(str(path))
        assert list(got) == list(want), path
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    for path in _spectrum_files(tmp_path)[:3]:
        for g, w in zip(tspectra.load_spectrum(str(path)), jspectra.load_spectrum(str(path))):
            np.testing.assert_array_equal(g, w)


def test_chain_files_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    matrix = np.column_stack([
        np.ones(40), rng.normal(-5000.0, 30.0, 40), rng.uniform(-3, 3, (40, 6)) * 10.0 ** rng.integers(-8, 8, (40, 6)),
    ])
    for mod, tag in ((jchains, "jax"), (tchains, "torch")):
        mod.write_stats(str(tmp_path / f"{tag}.stats"), 4985.123456789, 0.3125, ["a line", "p = 0.5"])
        mod.write_equal_weights(str(tmp_path / f"{tag}_ew.txt"), matrix)
    for name in (".stats", "_ew.txt"):
        assert (tmp_path / f"torch{name}").read_bytes() == (tmp_path / f"jax{name}").read_bytes()
    assert tchains.read_stats(str(tmp_path / "jax.stats")) == jchains.read_stats(str(tmp_path / "jax.stats"))
    np.testing.assert_array_equal(
        tchains.read_equal_weights(str(tmp_path / "jax_ew.txt")), matrix
    )


def test_port_modules_import_neither_jax_nor_mcalf_tpu():
    """Every module of mcalf_torch, imported in a fresh interpreter."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import mcalf_torch
        names = [m.name for m in pkgutil.walk_packages(mcalf_torch.__path__, "mcalf_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "mcalf_tpu") or m.startswith(("jax.", "mcalf_tpu.")))
        assert not bad, bad
        new = {"mcalf_torch.analysis", "mcalf_torch.utils.checkpoint",
               "mcalf_torch.sampler.merge", "mcalf_torch.sampler.dynamic",
               "mcalf_torch.sampler.repeats", "mcalf_torch.sampler.graph",
               "mcalf_torch.utils.profiling", "mcalf_torch.plotting",
               "mcalf_torch.mocks", "mcalf_torch.utils.flops",
               "mcalf_torch.ops.reference_style", "mcalf_torch.parallel.fleet"}
        # the step-out bracket and the process group's entry points, too
        from mcalf_torch.ops.reference_style import make_reference_style_loglike
        from mcalf_torch.parallel import init_distributed, make_mesh
        from mcalf_torch.sampler.nested import _StepoutCarry, _stepout_pools
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "mcalf_tpu") or m.startswith(("jax.", "mcalf_tpu.")))
        assert not bad, bad
        assert new <= set(names), sorted(new - set(names))
        print("IMPORTED", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 25 and Path(mcalf_torch.__file__).parent.name == "mcalf_torch"


#: the port's tools and example, and a call of each that loads the modules
#: of mcalf_torch it runs
_PORT_SCRIPTS = {
    "tools/torch_truth_anchor.py": "mod.make_model(brange=(3.0, 40.0)); mod.grid_rows([0.5], [0.5], [0.5])",
    "tools/torch_coverage_study.py": "mod.make_problems(2, 1, 0.02)",
    "tools/torch_flagship_study.py": "mod.config(mod.make_model((8, 8)), 544, 100); mod.build_jobs('fixedk544')",
    "examples/model_grid_torch.py": "mod.fixed_model('testdata/civ_mock_spec.txt', 1, 2)",
}


@pytest.mark.parametrize("script", sorted(_PORT_SCRIPTS))
def test_port_scripts_import_neither_jax_nor_mcalf_tpu(script):
    """Each tool of the port and its example, imported and called in a fresh
    interpreter."""
    code = textwrap.dedent(f"""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location("script", {script!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        import mcalf_torch.parallel, mcalf_torch.sampler
        {_PORT_SCRIPTS[script]}
        assert "mcalf_torch.models.forward" in sys.modules
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "mcalf_tpu") or m.startswith(("jax.", "mcalf_tpu.")))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
