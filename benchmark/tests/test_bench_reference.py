"""The benchmark's plain reference against the fitter's plain CPU path, its
evidence against the sampler's own bookkeeping, and what it imports."""

import ast
import configparser
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from _common import CFGS, ROOT

from benchmark.reference import evidence
from benchmark.reference.physics import Problem, to_bf16, to_tf32

FORBIDDEN = {"jax", "jaxlib", "flax", "mcalf_tpu"}


def _port_forward(cfg, datadir=None):
    from mcalf_torch.config import readconfig
    from mcalf_torch.models import make_torch_forward
    from mcalf_torch.runner import build_model

    pars = readconfig(str(cfg))
    if datadir is None:
        pars["specfile"] = str(cfg.parent / pars["specfile"].rsplit("/", 1)[-1])
    model = build_model(pars)
    return model, make_torch_forward(model, "cpu")


def _assert_matches_the_port(ref, model, fwd, u):
    """Layout and bounds equal, -inf where the port's is, and every other
    log L within the port's bar (0.05 + 1e-5 |log L|); returns the
    reference's log L."""
    assert ref.ndim == model.ndim and ref.npix == model.npix
    assert ref.startind == model.startind
    np.testing.assert_array_equal(ref.lo, model.bounds_lo)
    np.testing.assert_array_equal(ref.hi, model.bounds_hi)
    assert ref.half == model.kernel_half_size()
    got = fwd.loglike_cube(torch.from_numpy(u)).numpy().astype(np.float64)
    want = ref.loglike(u)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    kept = np.isfinite(want)
    assert np.all(np.isfinite(got[kept]))
    assert np.all(np.abs(got[kept] - want[kept]) <= 0.05 + 1e-5 * np.abs(want[kept]))
    return want


@pytest.mark.parametrize("cfg", CFGS)
def test_reference_loglike_matches_the_port_plain_path(cfg):
    """float64 reference log L within the port's bar (0.05 + 1e-5 |log L|)
    of the port's plain float32 likelihood on seeded rows."""
    cfg = ROOT / cfg
    model, fwd = _port_forward(cfg)
    ref = Problem(str(cfg), str(cfg.parent))
    u = np.random.default_rng(7).random((16, ref.ndim)).astype(np.float32)
    _assert_matches_the_port(ref, model, fwd, u)


#: the flagship's .cfg with MC-ALF's nuisance keys: a sampled LSF width
#: (7-9 km/s about the published 8), a sampled continuum (+-2%), and the
#: asymmetric likelihood, alone and together
NUISANCE = {
    "free_resolution": {"input.specres": "7.0, 9.0"},
    "free_continuum": {"components.contval": "0.98, 1.02"},
    "both_with_asymmlike": {"input.specres": "7.0, 9.0", "components.contval": "0.98, 1.02",
                            "input.asymmlike": "True"},
    "asymmlike": {"input.asymmlike": "True"},
}


def _variant(tmp_path, changes):
    cp = configparser.ConfigParser()
    cp.read(ROOT / "testdata" / "fit.cfg")
    changes = dict(changes, **{"pathing.datadir": f"{ROOT / 'testdata'}/"})
    for key, value in changes.items():
        section, option = key.split(".", 1)
        cp.set(section, option, value)
    path = tmp_path / "fit.cfg"
    with open(path, "w") as fh:
        cp.write(fh)
    return path


@pytest.mark.parametrize("variant", sorted(NUISANCE))
def test_reference_takes_the_nuisance_keys_as_the_port(variant, tmp_path):
    """Each nuisance variant of the flagship: the layout (free slots before
    ncomp), bounds and LSF size of the port, and log L on seeded rows
    within the bar, with the -inf pattern exact.  Each of four seeded rows
    has its column densities set to a ladder from the prior's low end
    (a model near the continuum, which asymmlike keeps) upwards: the counts
    of residuals above 4 and 5 noise widths pass their limits on the way,
    the one above 4 first, so the ladder holds rows kept below the limits,
    rows rejected by the count above 4 alone, and rows rejected by both."""
    changes = NUISANCE[variant]
    cfg = _variant(tmp_path, changes)
    model, fwd = _port_forward(cfg, datadir=ROOT / "testdata")
    ref = Problem(str(cfg), str(ROOT / "testdata"))
    free = ("input.specres" in changes) + ("components.contval" in changes)
    assert ref.startind == free and ref.ndim == 34 + free
    ladder = np.arange(0.0, 0.32, 0.02, dtype=np.float32)
    u = np.repeat(np.random.default_rng(11).random((4, ref.ndim)).astype(np.float32),
                  ladder.size, axis=0)
    u[:, np.unique(ref.pidx)] = np.tile(ladder, 4)[:, None]
    want = _assert_matches_the_port(ref, model, fwd, u)
    if "input.asymmlike" in changes:
        rejected = np.isneginf(want).reshape(4, ladder.size)
        assert not rejected[:, 0].any() and rejected[:, -1].all()
        assert 8 <= rejected.sum() <= 4 * ladder.size - 8
    else:
        assert np.all(np.isfinite(want))


def test_reference_still_refuses_gaussian_priors(tmp_path):
    cfg = _variant(tmp_path, {"components.gpriors": "12.0, 0.5"})
    with pytest.raises(NotImplementedError, match="Gaussian priors"):
        Problem(str(cfg), str(ROOT / "testdata"))


def test_rounding_helpers():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11 + 2**-13, 3.14159265], np.float32)
    assert to_tf32(x)[0] == 1.0 and to_tf32(x)[1] == 1.0          # ties to even
    assert to_tf32(x)[2] == np.float32(1.0 + 2**-9)
    assert abs(to_bf16(x)[3] - 3.140625) < 1e-7


def test_evidence_from_a_written_sequence():
    """The reference's log Z and weights of a run from its log L sequence
    against the sampler's own float32 bookkeeping, and the merge of two
    runs against the fitter's merge."""
    from mcalf_torch.sampler import NSConfig, merge_results, nested_sample

    def loglike(u):
        return -0.5 * torch.sum(((u - 0.5) / 0.1) ** 2, dim=-1)

    cfg = NSConfig(ndim=2, nlive=40, num_delete=10, num_repeats=4, max_samples=200)
    runs = [nested_sample(loglike, torch.Generator().manual_seed(s), cfg, "cpu").numpy()
            for s in (1, 2)]
    for r in runs:
        nlive = len(r.logl) - 200
        n_del = int(r.n_dead) - nlive
        logl = np.asarray(r.logl, np.float64)
        z = evidence.run_logz(logl[:n_del], logl[200:200 + nlive], nlive, 10)
        assert abs(z - float(r.logz)) < 1e-4
        w, lw = evidence.run_weights(n_del, nlive, 10)
        np.testing.assert_allclose(np.asarray(r.logw, np.float64)[:n_del], w, atol=5e-5)
        np.testing.assert_allclose(np.asarray(r.logw, np.float64)[200:200 + nlive], lw, atol=5e-5)
    merged = merge_results(runs)
    pts = []
    for r in runs:
        ok = np.isfinite(np.asarray(r.logw, np.float64))
        pts.append((np.asarray(r.logl, np.float64)[ok], np.asarray(r.birth_logl, np.float64)[ok]))
    assert abs(evidence.merged_logz(pts) - merged.logz) < 1e-9


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_neither_jax_nor_the_fitter():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"mcalf_torch"}), path


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run of the harness in a fresh interpreter, then
    the top-level names of every loaded module against jax, jaxlib, flax
    and the JAX package, compared whole."""
    code = (
        "import sys, json; sys.path.insert(0, %r); import _common\n"
        "out = _common.tiny_run(trace=1)\n"
        "import run; print(json.dumps(run.forbidden_modules()))\n"
    ) % str(ROOT / "benchmark" / "tests")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
