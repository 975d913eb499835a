"""``fit_many`` of four seeds of the 1-comp CIV problem on the CPU, to
convergence, against the quadrature evidence: the port's twin of
tests/test_sharding.py::test_fit_many_sharded (whose 4983.62 is the
quadrature value of the reference's own mock; the repo's
testdata/civ_mock_spec.txt integrates to 4985.51, tools/truth_anchor.py)."""

from pathlib import Path

import numpy as np

from mcalf_torch.models import AbsorptionModel
from mcalf_torch.parallel import fit_many
from mcalf_torch.sampler import NSConfig

TESTDATA = Path(__file__).parents[1] / "testdata"
QUADRATURE_LOGZ = 4985.51


def test_fit_many_four_seeds_on_the_anchor():
    cfg = NSConfig(ndim=4, nlive=60, num_repeats=8, max_samples=4000,
                   precision_criterion=1e-2)
    res = fit_many([AbsorptionModel.from_file(
        str(TESTDATA / "civ_mock_spec.txt"), fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"], ncomp=(1, 1), specres=[8.0],
        Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )] * 4, cfg, seed=7, mesh=["cpu"])
    logz = res.logz.numpy().astype(np.float64)
    logzerr = res.logzerr.numpy().astype(np.float64)
    assert logz.shape == (4,) and np.isfinite(logz).all() and len(np.unique(logz)) == 4
    assert (res.termination_reason == 0).all()
    assert logz.max() - logz.min() < 6.0 * logzerr.mean(), (logz, logzerr)
    assert abs(logz.mean() - QUADRATURE_LOGZ) < 1.2, logz
