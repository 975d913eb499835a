"""FLOP census of the port (mcalf_torch/utils/flops.py): twins of
tests/test_flops.py's hand-counted cases under the same policy, exact
counts, and the flagship likelihood's census beside the JAX package's.

The port's census counts the aten ops a call runs, so where the JAX census
takes a ``cond``'s dearest branch or counts a ``while`` body once, the port
counts what ran (the loop and branch cases below).  The flagship's plain
likelihood evaluates the Harris expansion only inside each windowed
transition's window (u^2 < tmin), the wing formula everywhere; the JAX XLA
path evaluates both on every pixel.  With the window opened to every pixel
the two censuses count the same work, and the reference's band of 70-200
FLOP per (transition, pixel) holds.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcalf_tpu.atomic import get_lines as jget_lines
from mcalf_tpu.models import AbsorptionModel as JaxAbsorptionModel
from mcalf_tpu.models import make_jax_forward
from mcalf_tpu.utils.flops import flop_census as jax_flop_census
from mcalf_torch.atomic import get_lines
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.utils.flops import FLOP_WEIGHTS, flop_census


def test_weights_are_the_jax_modules():
    from mcalf_tpu.utils import flops as jflops

    assert FLOP_WEIGHTS == jflops.FLOP_WEIGHTS


def test_elementwise_counts():
    x = torch.ones((8, 16))
    c = flop_census(lambda x: torch.exp(x * 2.0 + 1.0) - x, x)
    assert c.flops == 4 * 128
    assert c.by_primitive["mul"] == 128
    assert c.by_primitive["exp"] == 128
    assert not c.has_while


def test_fused_and_compound_elementwise():
    x = torch.ones((4, 5))
    # addcmul = mul + add; clamp = max + min; reciprocal = div; x**2 = pow
    c = flop_census(
        lambda x: torch.addcmul(x, x, x).clamp(0.0, 1.0) + torch.reciprocal(x) + x**2, x
    )
    assert c.flops == 20 * (2 + 2 + 1 + 1 + 2)
    assert c.by_primitive["max"] == c.by_primitive["min"] == 20
    assert c.by_primitive["div"] == 20 and c.by_primitive["pow"] == 20
    # a one-sided clamp is one max (or one min)
    c = flop_census(lambda x: torch.clamp(x, min=1.0) + torch.clamp(x, max=2.0), x)
    assert c.flops == 20 * 3 and c.by_primitive["max"] == c.by_primitive["min"] == 20


def test_reduction_counts_input_size():
    x = torch.ones((8, 16))
    assert flop_census(lambda x: torch.sum(x), x).flops == 128
    c = flop_census(lambda x: x.amax(dim=-1), x)
    assert c.flops == 128 and c.by_primitive["reduce_max"] == 128
    # mean = a sum over the input and a division per output
    c = flop_census(lambda x: x.mean(dim=0), x)
    assert c.by_primitive["reduce_sum"] == 128 and c.by_primitive["div"] == 16


def test_matrix_products_2mnk():
    a = torch.ones((4, 5))
    b = torch.ones((5, 3))
    assert flop_census(lambda a, b: a @ b, a, b).flops == 2 * 4 * 3 * 5
    bb = torch.ones((2, 5, 3))
    c = flop_census(lambda a, b: torch.matmul(a.expand(2, 4, 5), b), a, bb)
    assert c.by_primitive["dot_general"] == 2 * 2 * 4 * 3 * 5
    # addmm: the product and one add per output element
    c = flop_census(lambda a, b: torch.addmm(torch.zeros(4, 3), a, b), a, b)
    assert c.flops == 2 * 4 * 3 * 5 + 4 * 3


def test_conv1d_counts_multiply_adds():
    x = torch.ones((6, 1, 50))
    w = torch.ones((1, 1, 7))
    c = flop_census(lambda x, w: F.conv1d(x, w), x, w)
    assert c.by_primitive["conv"] == 2 * 6 * 44 * 7 and c.flops == 2 * 6 * 44 * 7
    # grouped, with a bias: K multiply-adds per output and one add
    x = torch.ones((2, 3, 20))
    w = torch.ones((3, 1, 5))
    c = flop_census(lambda x, w: F.conv1d(x, w, torch.zeros(3), groups=3), x, w)
    assert c.by_primitive["conv"] == 2 * 2 * 3 * 16 * 5
    assert c.by_primitive["add"] == 2 * 3 * 16


def test_loop_counts_every_trip():
    x = torch.ones((16,))

    def f(x):
        carry = x
        for _ in range(7):
            carry = carry * 1.5 + x
        return carry

    c = flop_census(f, x)
    assert c.flops == 7 * 2 * 16
    assert not c.has_while


def test_branch_counts_the_branch_taken():
    x = torch.ones((16,))
    f = lambda x: x * 2.0 + 1.0 if bool(x[0] > 0.0) else x * 2.0
    assert flop_census(f, x).flops == 32
    assert flop_census(f, -x).flops == 16


def test_predicates_and_movement_are_zero_weight():
    x = torch.ones((8,))
    c = flop_census(
        lambda x: torch.where(x > 0.5, x, torch.zeros_like(x)).clone().reshape(2, 4), x
    )
    assert c.flops == 0
    assert c.unweighted["gt"] == 8 and c.unweighted["where"] == 8


N_PIX = 512


def _flagship_pair():
    wave = np.linspace(6180.0, 6220.0, N_PIX)
    kw = dict(
        wave=wave, flux=np.ones(N_PIX), noise=np.full(N_PIX, 0.02), ncomp=(8, 11),
        specres=[8.0], Nrange=[12.0, 14.5], brange=[10.0, 40.0], zrange=[2.99, 3.01],
    )
    return (JaxAbsorptionModel(lines=jget_lines(["CIV 1548", "CIV 1550"]), **kw),
            AbsorptionModel(lines=get_lines(["CIV 1548", "CIV 1550"]), **kw))


@pytest.mark.parametrize("window", ("opened", "as built"))
def test_flagship_likelihood_census_scale(window):
    """tests/test_flops.py's flagship case on the port's plain likelihood,
    beside the JAX census of the XLA path on the same model and inputs."""
    jm, m = _flagship_pair()
    B = 8
    x = np.full((B, m.ndim), 0.5, np.float32)
    fwd = make_torch_forward(m, "cpu")
    if window == "opened":
        fwd.tmin.fill_(float("inf"))  # every pixel inside the Harris window
    c = flop_census(fwd.loglike, torch.from_numpy(x))
    jc = jax_flop_census(make_jax_forward(jm, use_pallas=False).loglike, x)
    ntrans = int(m.transition_table()["pidx"].size)
    per_pair = c.flops / B / (ntrans * m.npix)
    jper_pair = jc.flops / B / (ntrans * m.npix)
    ratio = c.flops / jc.flops
    diff = {k: c.by_primitive[k] - jc.by_primitive[k]
            for k in set(c.by_primitive) | set(jc.by_primitive)}
    top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:4]
    print(f"window {window}: port {per_pair:.2f}, JAX {jper_pair:.2f} FLOP per "
          f"(transition, pixel), port/JAX {ratio:.4f}; port - JAX by op {top}")
    assert 70 <= jper_pair <= 200
    assert not c.has_while
    if window == "opened":
        assert 70 <= per_pair <= 200, per_pair
        assert 0.9 < ratio < 1.2, ratio
    else:
        # the wing on every pixel, the Harris expansion only in the window
        assert 10 <= per_pair < 0.5 * jper_pair, per_pair
