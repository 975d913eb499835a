"""Checkpoint / resume in the port: chunked stepping is bit-identical to one
shot, a reloaded checkpoint continues to the same answer (its generator
state rides with it), and the .npz files are the JAX package's: a checkpoint
written by ``mcalf_tpu.utils.checkpoint.save_state`` loads in the port field
for field.  Everything here is exact (bit for bit)."""

import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mcalf_torch.sampler import (
    NSConfig,
    finalize,
    init_state,
    is_done,
    nested_sample,
    nsstate_to_numpy,
    run_steps,
)
from mcalf_torch.utils import checkpoint as tckpt
from mcalf_torch.utils.checkpoint import (
    latest_checkpoint,
    load_state,
    problem_fingerprint,
    prune_checkpoints,
    save_state,
)

TESTDATA = Path(__file__).parents[1] / "testdata"


def _loglike(sigma=0.05, ndim=2):
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def f(u):
        return (norm - 0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2).to(
            torch.float32
        )

    return f


def _gen(seed):
    return torch.Generator().manual_seed(seed)


CFG = NSConfig(ndim=2, nlive=100, max_samples=8000).resolved()


def _same_state(a, b):
    a, b = nsstate_to_numpy(a), nsstate_to_numpy(b)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_chunked_equals_oneshot():
    ll = _loglike()
    one = nested_sample(ll, _gen(0), CFG, "cpu")

    gen = _gen(0)
    state = init_state(ll, gen, CFG, "cpu")
    while not is_done(state, CFG):
        state = run_steps(ll, state, CFG, 5, gen)  # 5 outer steps per chunk
    chunked = finalize(state, CFG)

    assert float(one.logz) == float(chunked.logz)
    assert one.n_like == chunked.n_like


def test_checkpoint_roundtrip_and_resume(tmp_path):
    ll = _loglike()

    # Run part of the way, checkpoint, reload, finish.
    gen = _gen(0)
    state = init_state(ll, gen, CFG, "cpu")
    state = run_steps(ll, state, CFG, 10, gen)
    state = state._replace(rng=gen.get_state())
    path = str(tmp_path / "ns_state_0010.npz")
    save_state(path, state)
    assert latest_checkpoint(str(tmp_path)) == path

    loaded = load_state(path, device="cpu")
    _same_state(state, loaded)
    assert isinstance(loaded.n_dead, int) and isinstance(loaded.step, int)

    # the generator handed in is put back to the checkpoint's state
    res_resumed = nested_sample(ll, _gen(99), CFG, "cpu", state=loaded)
    res_straight = nested_sample(ll, _gen(0), CFG, "cpu")
    assert float(res_resumed.logz) == float(res_straight.logz)
    assert res_resumed.n_like == res_straight.n_like


def test_resume_from_every_chunk_boundary_is_bit_identical(tmp_path):
    """The default schedule (first boundary at 8 outer steps, then every 32)
    with clustering on: a run resumed from any state its callback was handed
    ends as the uninterrupted run, samples and all."""
    ll = _loglike()
    cfg = NSConfig(ndim=2, nlive=60, num_delete=5, num_repeats=6, max_samples=3000)
    saved = []
    straight, final = nested_sample(
        ll, _gen(4), cfg, "cpu", on_chunk=saved.append, return_state=True
    )
    assert [s.step for s in saved[:3]] == [8, 40, 72]
    assert all(s.rng is not None for s in saved) and final.step == saved[-1].step
    for i, s in enumerate(saved):
        path = str(tmp_path / f"ns_state_{s.step:06d}.npz")
        save_state(path, s)
        steps = []
        res = nested_sample(
            ll, _gen(1234), cfg, "cpu", state=load_state(path, device="cpu"),
            on_chunk=lambda t: steps.append(t.step),
        )
        assert steps == [t.step for t in saved[i + 1:]]  # the same boundaries
        for a, b in zip(res.numpy(), straight.numpy()):
            np.testing.assert_array_equal(a, b)


def test_fingerprint_mismatch_rejected(tmp_path):
    # Resuming a checkpoint of a different problem/config/seed must raise,
    # not silently continue the wrong run.
    state = init_state(_loglike(), _gen(0), CFG, "cpu")
    path = str(tmp_path / "ns_state_0000.npz")
    fp = {"ndim": 2, "nlive": 100, "seed": 0, "data_hash": "abc", "rng_device": "cpu"}
    save_state(path, state, fingerprint=fp)

    # matching fingerprint loads fine
    load_state(path, fingerprint=fp, device="cpu")
    # any field differing is rejected
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_state(path, fingerprint=dict(fp, seed=1), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_state(path, fingerprint=dict(fp, data_hash="def"), device="cpu")
    # a checkpoint of the other device type says why it is refused
    with pytest.raises(ValueError, match="rng_device.*device type"):
        load_state(path, fingerprint=dict(fp, rng_device="cuda"), device="cpu")
    # a legacy checkpoint without fingerprints is rejected when one is required
    save_state(path, state)
    with pytest.raises(ValueError, match="no fingerprint"):
        load_state(path, fingerprint=fp, device="cpu")
    # ...but loads when no check is requested
    load_state(path, device="cpu")


def test_generator_state_of_other_device_type_refused():
    """A CUDA generator's state (16 bytes) cannot continue a CPU run."""
    ll = _loglike()
    state = init_state(ll, _gen(0), CFG, "cpu")
    state = state._replace(rng=torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="device type"):
        nested_sample(ll, _gen(0), CFG, "cpu", state=state)


def test_legacy_checkpoint_missing_dead_rank_backfilled(tmp_path):
    # Checkpoints written before the dead_rank diagnostic field existed must
    # still resume (the field is backfilled with -1 = unrecorded).
    state = init_state(_loglike(), _gen(0), CFG, "cpu")
    path = str(tmp_path / "ns_state_0000.npz")
    arrays = {
        k: v for k, v in nsstate_to_numpy(state).items()
        if k not in ("dead_rank", "live_cluster")
    }
    np.savez(path, **arrays)
    loaded = load_state(path, device="cpu")
    assert loaded.dead_rank.shape == (8000,) and loaded.dead_rank.dtype == torch.int32
    assert bool((loaded.dead_rank == -1).all())
    assert loaded.live_cluster.shape == (100,) and not bool(loaded.live_cluster.any())
    assert loaded.rng is None
    # ...but a genuinely essential field missing still raises
    arrays.pop("live_u")
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="missing fields"):
        load_state(path, device="cpu")


def test_prune_checkpoints(tmp_path):
    state = init_state(_loglike(), _gen(0), CFG, "cpu")
    for i in range(6):
        p = str(tmp_path / f"ns_state_{i:04d}.npz")
        save_state(p, state)
        os.utime(p, (time.time() + i, time.time() + i))
    assert not list(tmp_path.glob("*.tmp*"))  # written whole, then renamed
    prune_checkpoints(str(tmp_path), keep=2)
    left = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert left == ["ns_state_0004.npz", "ns_state_0005.npz"]
    # one tick of the clock: the step number in the name decides
    for p in tmp_path.glob("*.npz"):
        os.utime(p, (1e9, 1e9))
    assert latest_checkpoint(str(tmp_path)).endswith("ns_state_0005.npz")
    assert latest_checkpoint(str(tmp_path), prefix="ns_boost") is None


# ---- against the JAX package -------------------------------------------------

def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A checkpoint written by mcalf_tpu.utils.checkpoint.save_state loads in
    the port field for field (its PRNG key dropped), finishes there, and the
    port's own file loads back bit for bit."""
    import jax
    import jax.numpy as jnp

    from mcalf_tpu.sampler import nested as jn
    from mcalf_tpu.utils import checkpoint as jckpt

    def jll(u):
        norm = -0.5 * 2 * np.log(2 * np.pi * 0.05**2)
        return (norm - 0.5 * jnp.sum((u - 0.5) ** 2, axis=-1) / 0.05**2).astype(jnp.float32)

    jcfg = jn.NSConfig(ndim=2, nlive=100, max_samples=8000)
    js = jn.run_steps(jll, jn.init_state(jll, jax.random.PRNGKey(0), jcfg), jcfg, 6)
    fp = {"ndim": 2, "nlive": 100, "seed": 0, "data_hash": "abc"}
    path = str(tmp_path / "ns_state_000006.npz")
    jckpt.save_state(path, js, fingerprint=fp)

    ts = load_state(path, fingerprint=fp, device="cpu")  # the keys both packages have
    got = nsstate_to_numpy(ts)
    assert set(got) == set(js._fields) - {"key"} and ts.rng is None
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), err_msg=k)
    assert (ts.n_dead, ts.n_like, ts.step) == (int(js.n_dead), int(js.n_like), 6)
    assert ts.live_u.dtype == torch.float32 and ts.dead_rank.dtype == torch.int32
    with pytest.raises(ValueError, match="no fingerprint field 'rng_device'"):
        load_state(path, fingerprint=dict(fp, rng_device="cpu"), device="cpu")

    # it goes on in the port, on the generator passed in
    res = nested_sample(_loglike(), _gen(7), CFG, "cpu", state=ts)
    assert res.termination_reason == 0 and abs(float(res.logz)) < 0.5

    # the port's own file, written from that state, loads back bit for bit,
    # and in the JAX package under its field names
    mine = str(tmp_path / "port.npz")
    save_state(mine, ts._replace(rng=_gen(3).get_state()), fingerprint=fp)
    back = load_state(mine, fingerprint=fp, device="cpu")
    _same_state(back, ts._replace(rng=_gen(3).get_state()))
    with np.load(mine) as z:
        assert set(js._fields) - {"key"} <= set(z.files)


def test_problem_fingerprint_matches_jax_on_shared_keys():
    from mcalf_tpu.models import AbsorptionModel as JModel
    from mcalf_tpu.sampler import NSConfig as JConfig
    from mcalf_tpu.utils.checkpoint import problem_fingerprint as jfp
    from mcalf_torch.models import AbsorptionModel as TModel

    kw = dict(
        fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 2),
        specres=[8.0], Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )
    spec = str(TESTDATA / "civ_mock_spec.txt")
    jm, tm = JModel.from_file(spec, **kw), TModel.from_file(spec, **kw)
    for cfgkw in (dict(nlive=60, max_samples=900), dict(nlive=50, num_repeats=7, num_delete=3)):
        want = jfp(jm, JConfig(ndim=jm.ndim, **cfgkw), 43)
        got = problem_fingerprint(tm, NSConfig(ndim=tm.ndim, **cfgkw), 43, "cpu")
        assert {k: got[k] for k in want} == want
        assert set(got) - set(want) == {"rng_device"} and got["rng_device"] == "cpu"
    assert problem_fingerprint(tm, NSConfig(ndim=7), 1, "cuda:0")["rng_device"] == "cuda"
    assert tckpt.problem_fingerprint(tm, NSConfig(ndim=7), 1, "cpu")["seed"] == 1


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a device, load_state and problem_fingerprint take the current
    CUDA device, as every other entry point of the port does, and raise
    without one, naming device="cpu"; nothing moves to the CPU unasked."""
    from mcalf_torch.models import AbsorptionModel

    path = str(tmp_path / "ns_state_0000.npz")
    save_state(path, init_state(_loglike(), _gen(0), CFG, "cpu"))
    model = AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 1), specres=[8.0],
        Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_state(path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        problem_fingerprint(model, CFG, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert problem_fingerprint(model, CFG, 1)["rng_device"] == "cuda"
