"""The port's fleet across processes: two local processes over ``gloo`` on
the CPU, as tests/test_distributed.py runs the JAX package's two-process
mesh over local TCP.

* ``init_distributed`` returns 2; ``make_mesh`` holds one entry per process;
* ``fit_many`` of 4 problems on the 2-process mesh returns, in each
  process, the full stacked results, and each process's block is bit for
  bit the one-process fleet of that block (same generators);
* the twin of tests/test_sharding.py::test_fit_stacked_sharded_checkpoint_resume:
  one checkpoint per rank, written by ``on_chunk`` with the block's global
  problem indices, resumed byte for byte;
* ``cli.main`` under a ``torchrun``-style environment (``WORLD_SIZE``,
  ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) with ``[run] seeds``: rank 0
  alone writes, and the files are those of a one-process run byte for byte;
* the same with a ``[pc_settings]`` section and no seeds: a fit that is not
  split runs on both ranks, rank 0 alone writes its chain files and its
  rolling checkpoints under ``<base>_resume/``, and they are a one-process
  run's.

Each process has a time limit of its own; the tests skip only where the
process group cannot form (no free port, a closed loopback), as the JAX
test does.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.cli import main
from mcalf_torch.models import AbsorptionModel
from mcalf_torch.parallel import fit_many
from mcalf_torch.parallel.fleet import _default_generators
from mcalf_torch.sampler import NSConfig

REPO = Path(__file__).parents[1]
TESTDATA = REPO / "testdata"
TIMEOUT_S = 240

_CIV = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], specres=[8.0],
    Nrange=[12.0, 14.5], zrange=[2.99, 3.01], brange=[10.0, 40.0], ncomp=(1, 1),
)
FLEET_CFG = dict(ndim=4, nlive=40, num_repeats=2, max_samples=600)
RESUME_CFG = dict(ndim=4, nlive=40, num_repeats=2, max_samples=1000,
                  precision_criterion=0.2)

_PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from mcalf_torch.models import AbsorptionModel
from mcalf_torch.sampler import NSConfig
RANK = int(sys.argv[1])
OUT = {out!r}
CIV = {civ!r}

def problems():
    names = ["civ_mock_spec.txt", "civ_mock_spec_multicomp.txt"] * 2
    return [AbsorptionModel.from_file(os.path.join({testdata!r}, n), **CIV) for n in names]
"""

_FLEET_WORKER = """
from mcalf_torch.models.batched import stack_problems
from mcalf_torch.parallel import MeshEntry, fit_many, fit_stacked, init_distributed, make_mesh
from mcalf_torch.utils.checkpoint import load_state, save_state

n = init_distributed(coordinator_address={addr!r}, num_processes=2, process_id=RANK,
                     local_device_ids=["cpu"])
print("WORLD", n, flush=True)
mesh = make_mesh()
assert mesh == [MeshEntry(0, torch.device("cpu")), MeshEntry(1, torch.device("cpu"))], mesh
res = fit_many(problems(), NSConfig(**{fleet!r}), seed=1, mesh=mesh)
np.savez(os.path.join(OUT, f"fleet_{{RANK}}.npz"),
         **{{k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in res._asdict().items()}})

# one checkpoint per rank: this rank's block after its first chunk
spec, stacked = stack_problems(problems())
cfg = NSConfig(**{resume!r})
path = os.path.join(OUT, f"ckpt_{{RANK}}.npz")
seen = []

def on_chunk(states, block):
    seen.append(list(block))
    if len(seen) == 1:
        save_state(path, states)

straight = fit_stacked(spec, stacked, cfg, seed=5, mesh=mesh, chunk_steps=3, on_chunk=on_chunk)
assert len(seen) >= 2, seen
assert all(b == [2 * RANK, 2 * RANK + 1] for b in seen), seen
resumed = fit_stacked(spec, stacked, cfg, seed=5, mesh=mesh, chunk_steps=3,
                      states=load_state(path))
for k, a in straight._asdict().items():
    b = getattr(resumed, k)
    assert np.array_equal(np.asarray(a.numpy() if torch.is_tensor(a) else a),
                          np.asarray(b.numpy() if torch.is_tensor(b) else b)), k
print("CHUNKS", len(seen), "OK", flush=True)
"""

_CLI_WORKER = """
from mcalf_torch import runner
from mcalf_torch.cli import main

writes = []
for name in ("write_stats", "write_equal_weights", "save_state", "prune_checkpoints"):
    fn = getattr(runner, name)
    setattr(runner, name, lambda path, *a, fn=fn, **k: (writes.append(path), fn(path, *a, **k))[1])
rc = main([{cfg!r}])
with open(os.path.join(OUT, f"writes_{{RANK}}.txt"), "w") as f:
    f.write("\\n".join(writes))
print("RC", rc, file=sys.__stdout__, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp_path, body, env_for=lambda rank: {}):
    """Two processes of ``body`` (after the prelude), ranks 0 and 1; skip
    if the process group does not form, raise on any other failure."""
    script = tmp_path / "worker.py"
    script.write_text(
        _PRELUDE.format(repo=str(REPO), out=str(tmp_path), civ=_CIV, testdata=str(TESTDATA))
        + body
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(rank)], cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(env, **env_for(rank)),
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a process ran past its {TIMEOUT_S} s")
    if any(p.returncode != 0 for p in procs):
        joined = "\n---\n".join(outs)
        formed = sum("WORLD 2" in o for o in outs) == 2 or "RC" in joined
        if not formed and ("Connection" in joined or "gloo" in joined.lower()
                           or "address" in joined.lower()):
            pytest.skip(f"the process group did not form here:\n{joined[-2000:]}")
        raise AssertionError(joined[-4000:])
    return outs


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    outs = _run_pair(tmp, _FLEET_WORKER.format(
        addr=f"127.0.0.1:{_free_port()}", fleet=FLEET_CFG, resume=RESUME_CFG))
    return tmp, outs


def test_init_distributed_returns_two(fleet_run):
    _, outs = fleet_run
    assert all("WORLD 2" in o for o in outs), outs


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_every_process_gets_the_full_results(fleet_run):
    tmp, _ = fleet_run
    r0, r1 = _load(tmp / "fleet_0.npz"), _load(tmp / "fleet_1.npz")
    assert r0["logz"].shape == (4,) and r0["samples_u"].shape[0] == 4
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.fixture(scope="module")
def models():
    names = ["civ_mock_spec.txt", "civ_mock_spec_multicomp.txt"] * 2
    return [AbsorptionModel.from_file(str(TESTDATA / n), **_CIV) for n in names]


@pytest.mark.parametrize("block", (0, 1))
def test_each_block_is_the_one_process_fleet(fleet_run, models, block):
    tmp, _ = fleet_run
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lo, hi = 2 * block, 2 * block + 2
        gens = _default_generators(1, 4, "cpu")[lo:hi]
        one = fit_many(models[lo:hi], NSConfig(**FLEET_CFG), mesh=["cpu"], generators=gens)
    finally:
        torch.set_num_threads(n)
    got = _load(tmp / f"fleet_{1 - block}.npz")  # the other process holds it too
    for k, v in one._asdict().items():
        want = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        np.testing.assert_array_equal(got[k][lo:hi], want, err_msg=k)


def test_per_rank_checkpoint_resumes_byte_for_byte(fleet_run):
    tmp, outs = fleet_run
    assert all("OK" in o for o in outs), outs
    assert (tmp / "ckpt_0.npz").exists() and (tmp / "ckpt_1.npz").exists()


CLI_CFG = """
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
chainfmt = fit_{{0}}

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
seeds = 3,4

[ns_settings]
nlive = 40
num_repeats = 4
max_samples = 400
precision_criterion = 0.01
"""


def test_cli_seeds_over_two_processes(tmp_path):
    port = _free_port()
    two = tmp_path / "two"
    two.mkdir()
    cfg = two / "fit.cfg"
    cfg.write_text(CLI_CFG.format(testdata=TESTDATA, out=two))
    env = lambda rank: dict(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    outs = _run_pair(two, _CLI_WORKER.format(cfg=str(cfg)), env_for=env)
    assert all("RC 0" in o for o in outs), outs
    assert "MC-ALF-Torch" in outs[0] and "MC-ALF-Torch" not in outs[1]  # rank 0 alone prints
    for rank in (0, 1):  # each process's own line on its stderr
        assert f"mcalf_torch rank {rank} of 2 on cpu: wall" in outs[rank], outs[rank]
    assert (two / "writes_1.txt").read_text() == ""
    written = (two / "writes_0.txt").read_text().split("\n")
    assert len(written) == 2 * 3  # two seeds and the merge, each .stats + equal weights

    one = tmp_path / "one"
    one.mkdir()
    (one / "fit.cfg").write_text(CLI_CFG.format(testdata=TESTDATA, out=one))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main([str(one / "fit.cfg")]) == 0
    finally:
        torch.set_num_threads(n)
    names = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file()
                   and p.name != "fit.cfg")
    assert names and any("_s3" in str(p) for p in names) and any("_s4" in str(p) for p in names)
    for rel in names:
        assert (two / rel).read_bytes() == (one / rel).read_bytes(), rel


def _one_process(one, text):
    one.mkdir()
    (one / "fit.cfg").write_text(text)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main([str(one / "fit.cfg")]) == 0
    finally:
        torch.set_num_threads(n)
    return sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file()
                  and p.name != "fit.cfg")


def test_cli_checkpoints_over_two_processes(tmp_path):
    """A fit that is not split (one seed) under two ranks: both run it on
    the same ``<base>_resume/`` paths, and rank 0 alone saves and prunes
    the checkpoints that ``[pc_settings]`` turns on."""
    text = (CLI_CFG.replace("seeds = 3,4\n", "")
            + "\n[pc_settings]\nnlive = 40\nprecision_criterion = 0.01\n")
    port = _free_port()
    two = tmp_path / "two"
    two.mkdir()
    cfg = two / "fit.cfg"
    cfg.write_text(text.format(testdata=TESTDATA, out=two))
    env = lambda rank: dict(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    outs = _run_pair(two, _CLI_WORKER.format(cfg=str(cfg)), env_for=env)
    assert all("RC 0" in o for o in outs), outs
    assert (two / "writes_1.txt").read_text() == ""
    written = (two / "writes_0.txt").read_text().split("\n")
    assert sum(w.endswith(".npz") for w in written) >= 1, written

    one = tmp_path / "one"
    names = _one_process(one, text.format(testdata=TESTDATA, out=one))
    ckpts = [p for p in names if p.parent.name.endswith("_resume")]
    assert ckpts and all(p.suffix == ".npz" for p in ckpts), names
    assert any(p.name.endswith("_dead-birth.txt") for p in names), names
    got = sorted(p.relative_to(two) for p in (two / ckpts[0].parent).iterdir())
    assert got == ckpts
    for rel in names:
        if rel in ckpts:  # an .npz carries its write time: compare the arrays
            with np.load(one / rel) as a, np.load(two / rel) as b:
                assert a.files == b.files, rel
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel}: {k}")
        else:
            assert (two / rel).read_bytes() == (one / rel).read_bytes(), rel
