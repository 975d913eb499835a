"""mcalf_torch's analysis phase (``plotting.run_plot``, ``plot_diagnostics``
and the CLI's ``doplot``) against mcalf_tpu's on the same chain files.

Both packages' ``run_plot`` read one set of chain files (seeded draws
written in the chain format, no fit) with ``[run] device = cpu``; what each
hands to matplotlib is recorded by wrapping ``Axes.plot``, ``Axes.step``
and ``pyplot.text`` and calling through.  Held equal: the data and noise
curves, the per-component curves and tick marks (both from float64 numpy
code), the banner and the ncomp table (character for character), the
figure's text.  The posterior-draw overlays come from the port's float32
``TorchForward.reconstruct`` ('wrap') against the JAX package's float64
numpy ``reconstruct_spec``: max |dflux| < 1e-5, the flux bar of
tests/test_torch_tau.py.

Fixtures: flagship-shaped (testdata/fit.cfg: ncomp 8-11, P = 1999, 150
rows, so the draws are the seeded pick of 100), the HI forest
(testdata/hi_forest.cfg: one filler, never-active NaN columns, 80 rows, so
every row is drawn) and a CIV model on two fit ranges (the panel grid).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_tpu import cli as jcli
from mcalf_tpu import plotting as jplotting
from mcalf_tpu.config import readconfig as jreadconfig
from mcalf_torch import cli as tcli
from mcalf_torch import plotting as tplotting
from mcalf_torch.config import readconfig as treadconfig
from mcalf_torch.io.chains import write_equal_weights, write_stats
from mcalf_torch.models import make_torch_forward
from mcalf_torch.mocks import HI_TRUTH, Z_TRUE
from mcalf_torch.ops import voigt_cuda
from mcalf_torch.runner import build_model
from mcalf_torch.sampler import equal_weights_matrix

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"

TWO_RANGES = """
[input]
specfile = civ_mock_spec.txt
wavefit = 6185,6198, 6200,6215
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
specres = 8.0

[pathing]
datadir = testdata/
outdir = testdata/output/
chainfmt = two_{0}

[components]
ncomp = 1,2
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = True
"""

#: fixture -> (config text, equal-weight rows, redshifts the active
#: components sit near, filler redshifts)
FIXTURES = {
    "flagship": ((TESTDATA / "fit.cfg").read_text(), 150, Z_TRUE, ()),
    "hi_forest": ((TESTDATA / "hi_forest.cfg").read_text(), 80,
                  [z for _, z, _ in HI_TRUTH], (4259.0 / 250.0 - 1.0,)),
    "two_ranges": (TWO_RANGES, 120, (3.0, 3.0005), ()),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Several test processes share the cores: torch's intra-op thread pool
    # only adds contention here (test_overlays_independent_of_threads holds
    # the overlays' bits across thread counts).
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name, tmp, text):
    text = text.replace("datadir = testdata/", f"datadir = {TESTDATA}/")
    text = text.replace("outdir = testdata/output/", f"outdir = {tmp}/")
    text = text.replace("dofit = True", "dofit = False\ndevice = cpu")
    path = tmp / f"{name}.cfg"
    path.write_text(text)
    return path


def _write_chains(cp, nrows, zs, zfill, seed):
    """Seeded posterior rows in the chain format: every parameter uniform
    over its prior, the active components' and fillers' redshifts near the
    given ones (so the draws put lines on the data)."""
    model = build_model(cp)
    rng = np.random.default_rng(seed)
    lo, hi = model.bounds_lo, model.bounds_hi
    p = lo + rng.uniform(size=(nrows, model.ndim)) * (hi - lo)
    for i, z in enumerate(list(zs)[: model.ncompmax]):
        p[:, model.startind + 2 + 3 * i] = z + rng.normal(0.0, 3e-5, nrows)
    for j, z in enumerate(zfill):
        p[:, model.endind + 3 * j + 1] = z + rng.normal(0.0, 3e-5, nrows)
    logl = rng.normal(900.0, 3.0, nrows)
    base = Path(cp["chaindir"]) / cp["chainfmt"].format(cp["nfill"])
    base.parent.mkdir(parents=True, exist_ok=True)
    write_stats(str(base) + ".stats", 890.25, 0.31)
    write_equal_weights(str(base) + "_equal_weights.txt", equal_weights_matrix(p, logl))
    return model


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """name -> config path, with its chain files written."""
    out = {}
    for seed, (name, (text, nrows, zs, zfill)) in enumerate(FIXTURES.items()):
        tmp = tmp_path_factory.mktemp(name)
        path = _config(name, tmp, text)
        _write_chains(treadconfig(str(path)), nrows, zs, zfill, seed)
        out[name] = path
    return out


def _record(monkeypatch):
    """Wrap Axes.plot, Axes.step and pyplot.text: each call's name,
    arguments (an Axes method's without the Axes) and keywords, then call
    through."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as pl
    from matplotlib.axes import Axes

    calls = []
    for owner, name, skip in ((Axes, "plot", 1), (Axes, "step", 1), (pl, "text", 0)):
        real = getattr(owner, name)

        def wrapped(*a, _real=real, _name=name, _skip=skip, **k):
            calls.append((_name, a[_skip:], k))
            return _real(*a, **k)

        monkeypatch.setattr(owner, name, wrapped)
    return calls


def _banner(out: str):
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("_____"))
    j = next(k for k, ln in enumerate(lines) if ln.startswith("|_____"))
    return lines[i : j + 1]


def _is_overlay(call):
    return call[0] == "plot" and call[2].get("color") == "red" and "alpha" in call[2]


def _compare(jcalls, tcalls):
    """Every call equal, the overlays within 1e-5; returns the worst overlay
    difference and the number of overlay curves."""
    assert len(tcalls) == len(jcalls)
    worst, n = 0.0, 0
    for (jn, ja, jk), (tn, ta, tk) in zip(jcalls, tcalls):
        assert (tn, tk) == (jn, jk)
        assert len(ta) == len(ja)
        if _is_overlay((jn, ja, jk)):
            np.testing.assert_array_equal(ta[0], ja[0])
            got, want = np.asarray(ta[1], np.float64), np.asarray(ja[1], np.float64)
            assert got.shape == want.shape and np.all(np.isfinite(got))
            worst = max(worst, float(np.max(np.abs(got - want))))
            n += 1
            continue
        for g, w in zip(ta, ja):
            if isinstance(w, str):
                assert g == w
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert worst < 1e-5, worst
    return worst, n


@pytest.mark.parametrize("name", tuple(FIXTURES))
def test_run_plot_matches_jax(name, chains, monkeypatch, capsys):
    path = chains[name]
    jcp, tcp = jreadconfig(str(path)), treadconfig(str(path))
    jcp["plotdir"] = str(path.parent / "plots_jax") + "/"
    calls = _record(monkeypatch)
    jpdf = jplotting.run_plot(jcp)
    jout = capsys.readouterr().out
    jcalls = list(calls)
    calls.clear()

    plain = voigt_cuda.voigt_tau_plain
    taus = []
    monkeypatch.setattr(voigt_cuda, "voigt_tau_plain", lambda *a: taus.append(1) or plain(*a))
    before = (voigt_cuda.launches, voigt_cuda.tau_launches)
    tpdf = tplotting.run_plot(tcp)
    tout = capsys.readouterr().out
    # the overlays: one batch through the plain tau version, no kernel
    assert len(taus) == 1
    assert (voigt_cuda.launches, voigt_cuda.tau_launches) == before

    assert Path(jpdf).is_file() and Path(tpdf).is_file()
    assert Path(tpdf) == path.parent / "plots" / Path(jpdf).name
    assert _banner(tout) == _banner(jout)
    chi2 = float(_banner(tout)[1].split("Chi2:")[1].split(",")[0])
    assert np.isfinite(chi2)
    worst, n = _compare(jcalls, calls)
    model = build_model(tcp)
    nsamp = min(FIXTURES[name][1], 100)
    assert n == nsamp * model.numfitranges
    assert sum(1 for c in calls if c[0] == "step") == model.numfitranges
    print(f"{name}: {n} overlay curves, max |dflux| {worst:.3g}")


def test_overlays_fill_never_active_columns(chains):
    """The HI forest's drawn rows hold never-active NaN columns; a 0 in
    their place (the JAX package's numpy path is immune, the port's masked
    batch is not) would poison whole rows: the overlays stay finite and
    equal the numpy reconstruction of each row."""
    cp = treadconfig(str(chains["hi_forest"]))
    model = build_model(cp)
    d = tplotting.plot_data(cp, model)
    assert np.isnan(d.draws).any() and d.overlays.shape == (80, model.npix)
    assert np.all(np.isfinite(d.overlays))
    want = np.stack([model.reconstruct_spec(np.nan_to_num(r, nan=0.0)) for r in d.draws])
    assert np.max(np.abs(d.overlays - want)) < 1e-5


def test_overlays_independent_of_threads(chains):
    """The plain overlays of the flagship fixture's 100 draws carry the same
    bits at 1, 2 and 4 intra-op threads; one row at a time moves them only
    by the rounding of 10**N in torch.pow's vectorised loop against its
    scalar tail (1.8e-7 measured)."""
    cp = treadconfig(str(chains["flagship"]))
    model = build_model(cp)
    rows = tplotting.plot_data(cp, model).draws
    fwd = make_torch_forward(model, "cpu", conv_mode="wrap")
    n = torch.get_num_threads()
    try:
        got = {}
        for threads in (1, 2, 4):
            torch.set_num_threads(threads)
            got[threads] = tplotting.posterior_overlays(model, fwd, rows)
    finally:
        torch.set_num_threads(n)
    assert np.array_equal(got[1], got[2]) and np.array_equal(got[1], got[4])
    one = np.concatenate([tplotting.posterior_overlays(model, fwd, r[None]) for r in rows])
    assert np.max(np.abs(one - got[1])) < 1e-6


def test_cli_plot_only_banner_matches_jax(chains, capsys):
    """``python -m mcalf_torch`` with dofit = False on the same chain files:
    the banner and the ncomp table character for character the JAX CLI's,
    and the PDF under ``plotdir``."""
    path = chains["two_ranges"]
    jpath = path.parent / "two_jax.cfg"
    jpath.write_text(path.read_text().replace("[pathing]", "[pathing]\nplotdir = plots_jax/"))
    assert jcli.main([str(jpath)]) == 0
    jout = capsys.readouterr().out
    assert tcli.main([str(path)]) == 0
    tout = capsys.readouterr().out
    assert _banner(tout) == _banner(jout)
    assert f"PDF written at: {path.parent}/plots/two_0.pdf" in tout
    assert (path.parent / "plots" / "two_0.pdf").is_file()


def test_without_matplotlib_banner_and_note(chains, monkeypatch, capsys):
    """With matplotlib hidden from import, run_plot still computes and
    prints everything, then says in one line that the PDF was not
    written."""
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = chains["hi_forest"]
    cp = treadconfig(str(path))
    cp["plotdir"] = str(path.parent / "plots_none") + "/"
    assert tplotting.run_plot(cp) is None
    out = capsys.readouterr().out
    banner = _banner(out)
    assert banner[1].startswith("| Ln(z): 890.250, Ln(L):") and "Chi2:" in banner[1]
    assert [ln for ln in out.splitlines() if ln.startswith("NOTE:")] == [
        f"NOTE: matplotlib is not installed; {cp['plotdir']}hi_fits_1.pdf was not written."
    ]
    assert not (path.parent / "plots_none" / "hi_fits_1.pdf").exists()


DEBUG_CFG = """
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata}/
outdir = {out}/
chainfmt = dbg_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
device = cpu

[ns_settings]
nlive = 40
num_repeats = 4
max_samples = 400
"""


def test_device_cpu_and_debug_diagnostics(tmp_path, capsys):
    """``--debug`` writes the sampler-diagnostics PNG beside the plots
    (twin of tests/test_e2e.py::test_device_cpu_and_debug_diagnostics, at a
    capped fit)."""
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(DEBUG_CFG.format(testdata=TESTDATA, out=tmp_path))
    assert tcli.main([str(cfg), "--debug"]) == 0
    png = tmp_path / "plots" / "dbg_0_diagnostics.png"
    assert png.is_file() and png.stat().st_size > 0
    assert f"Diagnostics written at: {png}" in capsys.readouterr().out
