"""benchmark/work.py: the count comes from shapes and physics only."""

import numpy as np
import pytest

from _common import CFGS, ROOT

from benchmark import work
from benchmark.reference.physics import Problem


@pytest.mark.parametrize("cfg", CFGS)
def test_count_ignores_the_wing_window_switch(cfg, monkeypatch):
    cfg = ROOT / cfg
    counts = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MCALF_TORCH_WINDOW", flag)
        counts.append(work.ops_per_eval(Problem(str(cfg), str(cfg.parent)), 11, 16))
    assert counts[0] == counts[1] > 0
    text = (ROOT / "benchmark" / "work.py").read_text()
    assert "win_tmin" not in text and "flop_census" not in text and "mcalf_torch" not in text


# one pixel of one transition: (u^2, a, active) -> operations
CASES = {
    "harris_region1": (1.0, 1e-4, True, 1 + 39),
    "harris_region2": (4.0, 1e-4, True, 1 + 40),
    "harris_region3": (10.0, 1e-4, True, 1 + 35),
    "harris_region4": (100.0, 1e-4, True, 1 + 30),
    "alg916_near": (1.0, 0.01, True, 1 + 180 + 246),
    "asymptotic_far": (200.0, 0.01, True, 1 + 180 + 43),
    "inactive": (1.0, 1e-4, False, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_count_of_one_pixel(case):
    x2, a, active, want = CASES[case]
    got = work.tau_ops(np.full((1, 1, 1), x2), np.full((1, 1), a), np.full((1, 1), active))
    assert got == want


def test_hand_count_of_a_row():
    # exp 10, LSF 3 taps x 2 over the 8 pixels it convolves, chi^2 4 x 10
    assert work.row_ops(10, 1) == 10 + 2 * 3 * 8 + 40
    assert work.row_ops(10, 0) == 10 + 40
    # 2 problems of T=2, P=3, K=3; 5 rows: rows 4T + K + cont + prob + 3 outputs
    class P:
        ntrans, npix, half, free_res = 2, 3, 1, False
    assert work.launch_bytes(P, 5, 2) == 4 * (5 * (8 + 3 + 1 + 1 + 3) + 2 * (6 + 12) + 4)
    least, bound = work.least_seconds(67e12, 1.0)
    assert least == 1.0 and bound == "operations"


# a problem's nuisance keys -> (operations a row adds, the LSF's entries a
# row reads): K = 3 taps, 10 pixels of which 8 valid
NUISANCE = {
    "none": ((False, False, False), 0.0, 3),
    "free_resolution": ((True, False, False), 3 * 3, 1),
    "free_continuum": ((False, True, False), 10, 3),
    "asymmlike": ((False, False, True), 2 * 8, 3),
    "all": ((True, True, True), 3 * 3 + 10 + 2 * 8, 1),
}


@pytest.mark.parametrize("case", sorted(NUISANCE))
def test_hand_count_of_the_nuisance_keys(case):
    (free_res, free_cont, asymm), ops, lsf = NUISANCE[case]

    class P:
        ntrans, npix, half = 2, 10, 1
        valid = np.arange(10) < 8

    P.free_res, P.free_cont, P.asymm = free_res, free_cont, asymm
    assert work.nuisance_row_ops(P) == ops
    # one row of one problem: 4T + the LSF's entries + continuum + 3 outputs
    assert work.launch_bytes(P, 1, 1) == 4 * ((8 + lsf + 1 + 3) + (20 + 40) + 4)
