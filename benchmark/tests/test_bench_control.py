"""The check's control: the plain reference in the program's place at the
next precision below float32 fails at least one of the cell's limits on
every seed, where the program passes them all.  On the CPU at a size a test
run holds; with the ``gpu`` mark at the cells' own sizes on the card
(``python -m pytest -m gpu benchmark/tests/test_bench_control.py``)."""

import json

import pytest

from _common import ROOT, TINY, WORKLOAD

from benchmark import control

SEEDS = (2**33 + 101, 2**33 + 102, 2**33 + 103)


def test_control_fails_on_the_cpu():
    rows = control.readings(WORKLOAD, SEEDS[:1], seconds=0.0, device="cpu",
                            extra=TINY, seeds_per_fit=2)
    for r in rows:
        assert r["correct"], r["program"]
        assert control.control_fails(r), r["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_at_the_cells_size(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = control.readings(workload, SEEDS, seconds=1.0)
    for r in rows:
        assert r["correct"], r["program"]
        assert control.control_fails(r), r["control"]
