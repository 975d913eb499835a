"""The slice as a whole: the 1-component CIV fit through both packages
(model -> likelihood -> nested sampler -> evidence) on the same data and
configuration.

The samplers draw different random numbers, so the comparison is
statistical: each evidence within 4 quoted errors of the quadrature value
of testdata/civ_mock_spec.txt (4985.51, tests/test_truth_anchor.py), and
the two within 4 combined quoted errors of each other.  The configuration
is cut to CPU size (nlive 50, 8 repeats), which widens the errors, not the
rule.
"""

import math
from pathlib import Path

import jax
import numpy as np
import torch

from mcalf_tpu.models import AbsorptionModel as JaxAbsorptionModel
from mcalf_tpu.models import make_jax_forward
from mcalf_tpu.sampler import NSConfig as JaxNSConfig
from mcalf_tpu.sampler import nested_sample as jax_nested_sample
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.sampler import NSConfig, insertion_rank_test, nested_sample

TESTDATA = Path(__file__).parents[1] / "testdata"
QUADRATURE_LOGZ = 4985.51
MODEL = dict(
    fitrange=[(6180.0, 6220.0)], fitlines=["CIV 1548", "CIV 1550"],
    ncomp=(1, 1), specres=[8.0], Nrange=[12.0, 14.5], brange=[10.0, 40.0],
    zrange=[2.99, 3.01],
)
SAMPLER = dict(ndim=4, nlive=50, max_samples=3000, num_repeats=8)


def test_one_component_fit_matches_jax():
    spec = str(TESTDATA / "civ_mock_spec.txt")
    jfwd = make_jax_forward(JaxAbsorptionModel.from_file(spec, **MODEL))
    jres = jax_nested_sample(jfwd.loglike_cube, jax.random.PRNGKey(0), JaxNSConfig(**SAMPLER))
    tfwd = make_torch_forward(AbsorptionModel.from_file(spec, **MODEL), "cpu")
    cfg = NSConfig(**SAMPLER)
    tres = nested_sample(
        tfwd.loglike_cube, torch.Generator().manual_seed(0), cfg, "cpu"
    ).numpy()

    jz, je = float(jres.logz), float(jres.logzerr)
    tz, te = float(tres.logz), float(tres.logzerr)
    assert int(jres.termination_reason) == 0 and tres.termination_reason == 0
    assert abs(jz - QUADRATURE_LOGZ) < 4 * je, (jz, je)
    assert abs(tz - QUADRATURE_LOGZ) < 4 * te, (tz, te)
    assert abs(jz - tz) < 4 * math.hypot(je, te), (jz, je, tz, te)
    assert insertion_rank_test(tres, cfg).p_value > 1e-3
    # posterior medians of (N, z, b) agree with the mock truth (13.8, 3.0, 15)
    w = np.exp(tres.log_posterior_weights - np.max(tres.log_posterior_weights))
    p = tfwd.cube_to_params(torch.from_numpy(tres.samples_u)).numpy()
    mean = (w[:, None] * p).sum(axis=0) / w.sum()
    assert abs(mean[1] - 13.8) < 0.1 and abs(mean[2] - 3.0) < 2e-4
    assert abs(mean[3] - 15.0) < 2.0
