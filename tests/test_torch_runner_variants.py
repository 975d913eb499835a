"""The runner's other fits through ``mcalf_torch.cli.main`` on the CPU (seed
ensembles, dynamic with ``[pc_settings]``, the repeats ladder, the fixed-k
grid, several spectra, kill-and-resume, stale resume files): twins of the
JAX package's tests/test_e2e.py at small nlive and max_samples, where a fit
stops at its cap far from convergence: these check the flow, the files and
their formats and what must be bit-identical, and leave the evidence to the
Gaussian tests of test_torch_merge/dynamic/repeats.py and to the card.  Then
the runner's host helpers and ``analysis.py`` against the JAX package's,
exact.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcalf_tpu import analysis as janalysis
from mcalf_tpu import runner as jrunner
from mcalf_torch import analysis as tanalysis
from mcalf_torch import runner as trunner
from mcalf_torch.analysis import analyze_chains
from mcalf_torch.cli import main
from mcalf_torch.config import readconfig
from mcalf_torch.io.chains import read_stats
from mcalf_torch.sampler import MergedRun, NSResults

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = """
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
chainfmt = {chainfmt}_{{0}}

[components]
ncomp = {ncomp}
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = {doplot}
device = cpu
{run}

{sections}
"""

NS = """[ns_settings]
nlive = 40
num_repeats = 4
max_samples = 400
precision_criterion = 0.01
"""


def write_cfg(path, out, *, sections=NS, run="", solver="polychord", chainfmt="fit",
              ncomp="1,1", specfile="civ_mock_spec.txt", doplot="False"):
    path.write_text(CFG.format(
        testdata=TESTDATA, out=out, sections=sections, run=run, solver=solver,
        chainfmt=chainfmt, ncomp=ncomp, specfile=specfile, doplot=doplot,
    ))
    return path


def _read_chain_pair(base, ncols=2 + 4):
    """A `.stats` + `_equal_weights.txt` pair in the reference formats."""
    lnz, err = read_stats(base + ".stats")
    assert np.isfinite(lnz) and err > 0
    lnz2, err2, lhood, post = analyze_chains(base)
    assert (lnz2, err2) == (lnz, err)
    assert post.shape[1] == ncols - 2 and np.all(np.isfinite(lhood)) and len(post) > 0
    return lnz, err, post


def test_seed_ensemble_through_cli(tmp_path):
    # [run] seeds: per-member chain files with the _s<seed> suffix plus ONE
    # merged .stats/_equal_weights under the base name.
    cfg = write_cfg(tmp_path / "fit.cfg", tmp_path, chainfmt="ens", run="seeds = 43,44,45")
    merged, base = trunner.run_fit(readconfig(str(cfg)))
    fits = tmp_path / "fits"
    assert isinstance(merged, MergedRun) and base == str(fits / "ens_0")
    members = [_read_chain_pair(str(fits / f"ens_0_s{s}")) for s in (43, 44, 45)]
    assert len({m[0] for m in members}) == 3  # three different runs
    stats = (fits / "ens_0.stats").read_text()
    assert "merged 3 seeds [43, 44, 45] by birth contours; seed spread = " in stats
    for s, (lnz_s, err_s, _) in zip((43, 44, 45), members):
        assert f"# seed {s}: logZ = {lnz_s:.3f} +/- {err_s:.3f}; insertion-rank KS p = " in stats
    lnz, err, post = _read_chain_pair(str(fits / "ens_0"))
    assert (lnz, err) == (merged.logz, merged.logzerr)
    # the merged posterior's rows are all the members' valid samples
    assert len(post) == sum(len(m[2]) for m in members)
    assert np.all((post[:, 1] >= 12.0) & (post[:, 1] <= 14.5))


def test_seeds_with_dynamic_raises(tmp_path):
    cfg = write_cfg(tmp_path / "fit.cfg", tmp_path, solver="dypolychord", run="seeds = 1,2")
    with pytest.raises(ValueError, match="seeds .* and dynamic sampling cannot be combined"):
        main([str(cfg)])
    cfg = write_cfg(tmp_path / "fit2.cfg", tmp_path, solver="dynesty",
                    sections=NS + "auto_repeats = True\n")
    with pytest.raises(ValueError, match="auto_repeats and dynamic sampling cannot be combined"):
        main([str(cfg)])


def _deadbirth_logz(dead):
    """Anesthetic's dead-birth evidence reconstruction: the live-point count
    at each death is recovered from the birth contours, so this checks the
    FILE is a self-consistent nested-sampling run, not just row counts."""
    logl = dead[:, -2]
    birth = dead[:, -1]
    order = np.argsort(logl, kind="stable")
    logl, birth = logl[order], birth[order]
    nlive = np.array(
        [np.sum((birth < li) & (logl >= li)) for li in logl], dtype=np.float64
    )
    logx = np.cumsum(np.log(nlive) - np.log(nlive + 1.0))
    logw = np.concatenate([[0.0], logx[:-1]]) - np.log(nlive + 1.0)
    a = logw + logl
    m = a.max()
    return m + np.log(np.sum(np.exp(a - m)))


def test_dypolychord_dynamic_end_to_end(tmp_path, capsys):
    # solver=dypolychord with a [pc_settings] section runs the two-pass
    # dynamic sampler through the full CLI, with the implicit resume
    # directory and the dead-birth file on by default; the chain files carry
    # the merged posterior.
    cfg = write_cfg(tmp_path / "fit.cfg", tmp_path, solver="dypolychord", chainfmt="dy",
                    sections="[pc_settings]\nnlive = 60\n\n"  # [ns_settings] nlive wins
                    + NS.replace("max_samples = 400", "max_samples = 1200"))
    assert main([str(cfg), "--debug"]) == 0
    out = capsys.readouterr().out
    assert "dynamic boost above lnL=" in out and "dynamic=True" in out
    fits = tmp_path / "fits"
    lnz, err, post = _read_chain_pair(str(fits / "dy_0"))
    # the base pass runs to convergence here (the boost needs a posterior):
    # logZ in the neighbourhood of the quadrature value 4985.51, N near 13.8
    assert 4975 < lnz < 4995, lnz
    assert abs(np.nanmedian(post[:, 1]) - 13.8) < 0.1
    stats = (fits / "dy_0.stats").read_text()
    assert "# insertion-rank KS p" in stats and "# boost insertion-rank KS p" in stats
    # both passes checkpointed under <base>_resume/, at most 3 files each
    for prefix in ("ns_state", "ns_boost"):
        n = len(list((fits / "dy_0_resume").glob(f"{prefix}_*.npz")))
        assert 1 <= n <= 3, (prefix, n)

    # The _dead-birth.txt carries BOTH passes: boost points are born at the
    # finite l_init contour, and a reconstruction of the evidence from
    # (logL, birth) pairs alone agrees with the shipped merged logZ.
    dead = np.loadtxt(fits / "dy_0_dead-birth.txt")
    assert dead.shape[1] == 4 + 2
    assert np.any(dead[:, -1] == -1e30), "no prior-born (base) points"
    assert np.any(dead[:, -1] > -1e29), "boost pass missing from dead-birth file"
    assert abs(lnz - _deadbirth_logz(dead)) < 3 * err + 0.3

    # a second invocation resumes both (terminal) passes and writes the
    # same files
    before = (fits / "dy_0.stats").read_bytes(), (fits / "dy_0_equal_weights.txt").read_bytes()
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "Resuming from checkpoint" in out and "Resuming boost pass from checkpoint" in out
    assert ((fits / "dy_0.stats").read_bytes(), (fits / "dy_0_equal_weights.txt").read_bytes()) == before


def test_auto_repeats_through_cli(tmp_path, capsys):
    sections = NS.replace("num_repeats = 4", "num_repeats = 2").replace(
        "max_samples = 400", "max_samples = 200") + "auto_repeats = true\n"
    cfg = write_cfg(tmp_path / "fit.cfg", tmp_path, chainfmt="auto", sections=sections,
                    run=f"checkpoint = {tmp_path / 'ck'}")
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "auto_repeats: evidence converged" in out or "auto_repeats ladder budget" in out
    assert "checkpoints/resume are not supported with auto_repeats" in out
    assert not (tmp_path / "ck").exists()
    _read_chain_pair(str(tmp_path / "fits" / "auto_0"))
    stats = (tmp_path / "fits" / "auto_0.stats").read_text()
    # the ladder line, at least two rungs, and a verdict for each final seed
    assert "# auto_repeats ladder converged=" in stats and "(rungs [2, 4" in stats
    assert "# seed0 insertion-rank KS p" in stats and "# seed1 insertion-rank KS p" in stats


def test_ncomp_grid_through_cli(tmp_path):
    cfg = write_cfg(tmp_path / "fit.cfg", tmp_path, chainfmt="grid", ncomp="1,2",
                    run="ncomp_grid = True")
    res, base = trunner.run_fit(readconfig(str(cfg)))
    assert isinstance(res, NSResults)  # the BEST-k results, not a bare int
    fits = tmp_path / "fits"
    assert base == str(fits / "grid_0")
    # each k had its own model: 4 and 7 physical parameters
    lnz = {k: _read_chain_pair(str(fits / f"grid_0_k{k}"), ncols=2 + 1 + 3 * k)[0] for k in (1, 2)}
    best = max(lnz, key=lnz.get)
    table = (fits / "grid_0_ncomp_grid.txt").read_text().splitlines()
    assert len(table) == 4 and table[0] == "# k  logZ  logZerr  dlogZ_vs_best"
    assert [ln.split()[0] for ln in table[1:3]] == ["1", "2"]
    assert [float(ln.split()[1]) for ln in table[1:3]] == [round(lnz[1], 4), round(lnz[2], 4)]
    assert table[3].startswith(f"# best k = {best}; trans-dimensional evidence")
    # best-k chains copied to the base name; returned results match them
    for suffix in (".stats", "_equal_weights.txt"):
        assert (fits / f"grid_0{suffix}").read_bytes() == (
            fits / f"grid_0_k{best}{suffix}").read_bytes()
    assert lnz[best] == float(res.logz)


def test_multi_spectrum_sequential(tmp_path, capsys):
    # ``specfile`` as a comma list (the same file twice -> the stem collision
    # disambiguator kicks in): one fit per spectrum under per-spectrum
    # suffixes, and one plot each.
    cfg = write_cfg(tmp_path / "multi.cfg", tmp_path, chainfmt="ms", doplot="True",
                    specfile="civ_mock_spec.txt, civ_mock_spec.txt")
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    fits, plots = tmp_path / "fits", tmp_path / "plots"
    for stem in ("civ_mock_spec", "civ_mock_spec1"):
        _read_chain_pair(str(fits / f"ms_0_{stem}"))
        assert out.count(f"Analyzing run: ms__{stem}\n") == 1
        assert out.count(f"PDF written at: {plots / f'ms_0_{stem}.pdf'}\n") == 1
        assert (plots / f"ms_0_{stem}.pdf").is_file()
    assert out.count("| Ncomp: 01 Occurrence Fraction: 1.000") == 2
    assert out.count("--- fitting ") == 2
    # the same seed on the same spectrum: the two fits are one fit
    assert (fits / "ms_0_civ_mock_spec.stats").read_bytes() == (
        fits / "ms_0_civ_mock_spec1.stats").read_bytes()


# 60 outer steps: chunk boundaries at 8 and 40, the end at the cap
RESUME_NS = """[ns_settings]
nlive = 40
num_delete = 5
num_repeats = 3
max_samples = 300
precision_criterion = 0.01
"""


def test_cli_kill_and_resume_bit_identical(tmp_path, capsys, monkeypatch):
    # A fit killed mid-run restarts from its latest checkpoint and finishes
    # byte for byte as an uninterrupted run (.stats and _equal_weights.txt).
    ref_out = tmp_path / "ref"
    assert main([str(write_cfg(tmp_path / "ref.cfg", ref_out, chainfmt="res",
                               sections=RESUME_NS, run="seed = 43"))]) == 0

    int_out, ckpt_dir = tmp_path / "int", tmp_path / "ckpt"
    cfg_int = write_cfg(tmp_path / "int.cfg", int_out, chainfmt="res", sections=RESUME_NS,
                        run=f"seed = 43\ncheckpoint = {ckpt_dir}")

    class Killed(RuntimeError):
        pass

    real_save = trunner.save_state
    calls = {"n": 0}

    def dying_save(*a, **k):
        real_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            raise Killed("simulated mid-fit crash, after the second checkpoint")

    monkeypatch.setattr(trunner, "save_state", dying_save)
    with pytest.raises(Killed):
        main([str(cfg_int)])
    monkeypatch.setattr(trunner, "save_state", real_save)
    assert sorted(p.name for p in ckpt_dir.glob("*.npz")) == [
        "ns_state_000008.npz", "ns_state_000040.npz"]
    assert not (int_out / "fits" / "res_0.stats").exists()

    # Second invocation resumes past the crash and completes.
    capsys.readouterr()
    assert main([str(cfg_int)]) == 0
    assert f"Resuming from checkpoint {ckpt_dir / 'ns_state_000040.npz'}" in capsys.readouterr().out
    assert len(list(ckpt_dir.glob("ns_state_*.npz"))) <= 3
    for name in ("res_0.stats", "res_0_equal_weights.txt"):
        assert (int_out / "fits" / name).read_bytes() == (ref_out / "fits" / name).read_bytes()

    # the explicit surface keeps the hard refusal: another seed's checkpoint
    cfg_44 = write_cfg(tmp_path / "s44.cfg", int_out, chainfmt="res", sections=RESUME_NS,
                       run=f"seed = 44\ncheckpoint = {ckpt_dir}")
    with pytest.raises(ValueError, match="fingerprint mismatch on 'seed'"):
        main([str(cfg_44)])


def test_pc_settings_resume_surface(tmp_path, capsys):
    # read_resume/write_resume from [pc_settings] map onto the sampler-state
    # checkpoints under <chain base>_resume/, and write_dead emits the
    # PolyChord/anesthetic _dead-birth.txt.
    sections = ("[pc_settings]\nnlive = 40\nnum_repeats = 3\nprecision_criterion = 0.01\n"
                "read_resume = True\nwrite_resume = True\n\n"
                "[ns_settings]\nnum_delete = 5\nmax_samples = 300\n")
    cfg = write_cfg(tmp_path / "fit.cfg", tmp_path, chainfmt="pcres", sections=sections)
    assert main([str(cfg)]) == 0
    fits = tmp_path / "fits"
    resume_dir = fits / "pcres_0_resume"
    # Per-chunk checkpoints are pruned as they are written (keep=3).
    assert 1 <= len(list(resume_dir.glob("ns_state_*.npz"))) <= 3
    stats0 = (fits / "pcres_0.stats").read_bytes()
    dead = np.loadtxt(fits / "pcres_0_dead-birth.txt")
    assert dead.shape[1] == 4 + 2  # ndim=4 params, logl, birth
    assert np.all(dead[:, -1] <= dead[:, -2])  # birth contour below logl
    assert np.any(dead[:, -1] == -1e30)  # prior-born points sentinel

    # Re-invocation resumes from the (terminal) checkpoint instead of
    # refitting, and reproduces the chain files bit-identically.
    capsys.readouterr()
    assert main([str(cfg)]) == 0
    assert "Resuming from checkpoint" in capsys.readouterr().out
    assert (fits / "pcres_0.stats").read_bytes() == stats0

    # read_resume=False ignores the checkpoints (fresh fit, no resume line).
    cfg2 = tmp_path / "fit2.cfg"
    cfg2.write_text(cfg.read_text().replace("read_resume = True", "read_resume = False"))
    assert main([str(cfg2)]) == 0
    assert "Resuming from checkpoint" not in capsys.readouterr().out
    assert (fits / "pcres_0.stats").read_bytes() == stats0  # the same fit again

    # STALE resume files (the sampler config was edited since they were
    # written) must not abort the run on this implicitly-enabled surface:
    # warn and refit fresh.
    cfg3 = tmp_path / "fit3.cfg"
    cfg3.write_text(cfg.read_text().replace("num_repeats = 3", "num_repeats = 4"))
    assert main([str(cfg3)]) == 0
    out = capsys.readouterr().out
    assert "starting a fresh fit" in out, out
    assert np.isfinite(np.loadtxt(fits / "pcres_0_equal_weights.txt")).all()
    assert (fits / "pcres_0.stats").read_bytes() != stats0


# ---- host helpers against the JAX package (exact) -----------------------------

def test_spectrum_subconfigs_matches_jax():
    cp = {"specfile": "a/x.txt", "specfiles": ["a/x.txt", "b/x.txt", "b/y.dat", "c/x.txt"],
          "chainfmt": "pc_{0}", "checkpoint": "ck", "nfill": 0}
    assert trunner.spectrum_subconfigs(cp) == jrunner.spectrum_subconfigs(cp)
    stems = [s["chainfmt"] for s in trunner.spectrum_subconfigs(cp)]
    assert stems == ["pc_{0}_x", "pc_{0}_x1", "pc_{0}_y", "pc_{0}_x2"]
    single = {"specfile": "one.txt", "chainfmt": "f"}
    assert trunner.spectrum_subconfigs(single) == jrunner.spectrum_subconfigs(single)


class _AffineForward(torch.nn.Module):
    """A stand-in forward model: float32 x -> 2 x - 1 is exact, so both
    packages' writers see the same physical parameters."""

    def __init__(self):
        super().__init__()
        self.register_buffer("two", torch.tensor(2.0))

    def cube_to_params(self, u):
        return self.two * u - 1.0


def _fake_run(seed, n=50, ndim=3):
    rng = np.random.default_rng(seed)
    logw = rng.normal(-5.0, 1.0, n).astype(np.float32)
    logw[rng.integers(0, n, 8)] = -np.inf
    birth = rng.normal(-40.0, 3.0, n).astype(np.float32)
    birth[:10] = -np.inf
    return SimpleNamespace(
        samples_u=rng.uniform(size=(n, ndim)).astype(np.float32), logw=logw,
        logl=rng.normal(-30.0, 3.0, n).astype(np.float32), birth_logl=birth,
    )


def test_write_dead_birth_matches_jax(tmp_path):
    runs = [_fake_run(1), _fake_run(2, n=30)]
    jfwd = SimpleNamespace(cube_to_params=lambda u: np.float32(2.0) * np.asarray(u) - np.float32(1.0))
    for k in (1, 2):
        jrunner._write_dead_birth(str(tmp_path / "j.txt"), jfwd, *runs[:k])
        trunner._write_dead_birth(str(tmp_path / "t.txt"), _AffineForward(), *runs[:k])
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    dead = np.loadtxt(tmp_path / "t.txt")
    assert dead.shape == (sum(int(np.isfinite(r.logw).sum()) for r in runs), 5)
    assert np.sum(dead[:, -1] == -1e30) > 0


def test_ncomp_grid_table_matches_jax(tmp_path, monkeypatch):
    """Both runners' grid over fixed fits that return the same evidences."""
    logz = {1: (4985.123456, 0.31), 2: (4983.9, 0.3456789), 3: (4985.0, 0.2)}

    def fake_fit(root):
        def run_fit(cp, debug=False):
            k = int(cp["ncomp"][0])
            base = str(root / cp["chainfmt"].format(0))
            Path(base + ".stats").write_text(f"k{k}\n")
            return SimpleNamespace(logz=np.float32(logz[k][0]), logzerr=np.float32(logz[k][1])), base

        return run_fit

    for mod, tag in ((jrunner, "j"), (trunner, "t")):
        root = tmp_path / tag
        root.mkdir()
        monkeypatch.setattr(mod, "run_fit", fake_fit(root))
        cp = {"ncomp": np.array([1, 3]), "chaindir": str(root), "chainfmt": "g_{0}", "nfill": 0}
        res, base = mod._run_ncomp_grid(cp)
        assert float(res.logz) == np.float32(logz[1][0]) and base == str(root / "g_0")
        assert (root / "g_0.stats").read_text() == "k1\n"  # the best k's file
    want = (tmp_path / "j" / "g_0_ncomp_grid.txt").read_bytes()
    assert (tmp_path / "t" / "g_0_ncomp_grid.txt").read_bytes() == want
    assert want.decode().splitlines()[0] == "# k  logZ  logZerr  dlogZ_vs_best"


def test_analysis_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    n, startind, K = 80, 1, 3
    post = rng.uniform(0.0, 1.0, (n, startind + 1 + 3 * (K + 1)))
    post[:, startind] = rng.uniform(0.0, K + 0.999, n)
    for nfill in (0, 1):
        for si in (None, startind):
            np.testing.assert_array_equal(
                tanalysis.sort_components(post, startind=si, nfill=nfill),
                janalysis.sort_components(post, startind=si, nfill=nfill),
            )
    for ncomp, cont in ((0, False), (3, True), (2, False)):
        assert tanalysis.get_parnames(ncomp, cont) == janalysis.get_parnames(ncomp, cont)
    for a, b in zip(tanalysis.ncomp_occurrence(post, startind),
                    janalysis.ncomp_occurrence(post, startind)):
        np.testing.assert_array_equal(a, b)
    # analyze_chains on a chain file pair written by the port
    from mcalf_torch.io.chains import write_equal_weights, write_stats

    base = str(tmp_path / "an_0")
    write_stats(base + ".stats", 4985.25, 0.4, ["insertion-rank KS p = 0.5"])
    write_equal_weights(base + "_equal_weights.txt",
                        np.column_stack([np.ones(n), rng.normal(-9970, 3, n), post]))
    for kw in (dict(), dict(return_sorted=False), dict(nfill=1)):
        got, want = tanalysis.analyze_chains(base, **kw), janalysis.analyze_chains(base, **kw)
        assert got[:2] == want[:2] == (4985.25, 0.4)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
