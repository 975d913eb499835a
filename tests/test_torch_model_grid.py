"""examples/model_grid_torch.py, the port's twin of examples/model_grid.py,
at a tiny nlive on the CPU: both fixed-ncomp fleets run, and the evidence
table (merged logZ per model, its difference from the best: the log Bayes
factor) and each model's seeds are printed."""

import importlib.util
import re
from pathlib import Path

EXAMPLE = Path(__file__).parents[1] / "examples" / "model_grid_torch.py"


def test_model_grid_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("model_grid_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--nlive", "16", "--max-samples", "160",
                     "--num-repeats", "3"]) == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^\s+(\d)\s+\|\s+([-\d.]+) \+/-\s+([\d.]+)\s+\|\s+([-\d.]+)$", out, re.M)
    assert [r[0] for r in rows] == ["1", "2"]
    dz = [float(r[3]) for r in rows]
    assert max(dz) == 0.0 and min(dz) <= 0.0
    assert len(re.findall(r"ncomp = \d seeds: ", out)) == 2
    assert "Preferred model: ncomp = " in out
    # the pinned ncomp prior: each fixed model's bounds hold one value
    m = mod.fixed_model(str(Path(__file__).parents[1] / "testdata" / "civ_mock_spec.txt"), 2, 2)
    assert m.bounds[m.startind] == (2.0, 2.001)
