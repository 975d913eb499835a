"""The reference's readings of every configuration it took before it took
the nuisance keys (free resolution, free continuum, asymmlike), pinned bit
for bit: the layout, bounds, LSF, log L on 16 seeded rows (plain and with
the control's TF32 convolution), and ``work.py``'s count, which the
benchmark's roofline and peak shares divide by.  ``pinned_readings.json``
holds the values that the reference and ``work.py`` gave before those keys
were added, for the ``.cfg`` of each configuration then and the HI forest."""

import json

import numpy as np
import pytest

from _common import CFGS, ROOT

from benchmark import work
from benchmark.reference.physics import Problem

PINNED = json.loads((ROOT / "benchmark" / "tests" / "pinned_readings.json").read_text())


def _bits(values) -> bytes:
    return np.asarray(values, np.float64).tobytes()


def test_every_pinned_cfg_is_still_compared():
    assert set(PINNED) <= set(CFGS)


@pytest.mark.parametrize("cfg", sorted(PINNED))
def test_reference_readings_are_the_pinned_ones(cfg):
    want = PINNED[cfg]
    path = ROOT / cfg
    problem = Problem(str(path), str(path.parent))
    assert (problem.ndim, problem.half) == (want["ndim"], want["half"])
    for key in ("lo", "hi", "taps"):
        assert _bits(getattr(problem, key)) == _bits(want[key]), key
    u = np.random.default_rng(7).random((16, problem.ndim)).astype(np.float32)
    assert _bits(problem.loglike(u)) == _bits(want["loglike"])
    assert _bits(problem.loglike(u, tf32=True)) == _bits(want["loglike_tf32"])
    assert _bits(work.ops_per_eval(problem, 7)) == _bits(want["ops_per_eval_7"])
    for shape, nbytes in want["launch_bytes"].items():
        rows, problems = (int(x) for x in shape.split(","))
        assert work.launch_bytes(problem, rows, problems) == nbytes, shape
