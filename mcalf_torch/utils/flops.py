"""FLOP census of a PyTorch function, from the aten ops it runs.

The port's counterpart of :mod:`mcalf_tpu.utils.flops`, under the same
counting policy and the same names, so that a census of the port's plain
PyTorch version and the JAX package's census of its XLA path can be set
side by side op by op.  The JAX module walks a jaxpr; this one runs the
function once under a ``TorchDispatchMode`` and counts every aten op as it
executes, on whatever device its tensors lie.

Counting policy (``FLOP_WEIGHTS``, keyed by the JAX primitive names):

* elementwise arithmetic (add/sub/mul/div/neg/max/min) -- 1 FLOP per
  output element, so a fused multiply-add counts 2.  ``addcmul`` and
  ``addcdiv`` count their two ops, ``clamp`` a max per lower bound and a
  min per upper bound,
  ``reciprocal`` a division.
* transcendentals (exp/log/sqrt/pow/...) -- 1 FLOP per output element, a
  deliberate lower bound, as in the JAX module.
* reductions (sum/amax/amin/prod/argmax/cumsum/...) -- one op per INPUT
  element; ``mean`` adds one division per output element, as ``jnp.mean``
  lowers to a sum and a division.
* matrix products (mm/bmm/mv/dot, the product of addmm/baddbmm) --
  2*M*N*K under ``dot_general``; a convolution -- its multiply-adds times 2
  under ``conv``, plus one add per output element for a bias.
* comparisons, selects and data movement (where/gt/copy/index/cat/...)
  -- 0 FLOPs, recorded in :attr:`FlopCensus.unweighted`.

Control flow: eager PyTorch has no scan, cond or while.  A Python loop
runs its body once per trip and every trip is counted; a data-dependent
branch counts the branch taken (the JAX module counts a ``cond``'s most
expensive branch); :attr:`FlopCensus.has_while` is always false and is
kept for the JAX module's interface.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["FLOP_WEIGHTS", "FlopCensus", "flop_census"]

#: FLOPs per OUTPUT element by JAX primitive name (reductions separate),
#: as in :data:`mcalf_tpu.utils.flops.FLOP_WEIGHTS`.
FLOP_WEIGHTS = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1,
    "max": 1, "min": 1, "rem": 1,
    "exp": 1, "exp2": 1, "log": 1, "log1p": 1, "expm1": 1,
    "sqrt": 1, "rsqrt": 1, "cbrt": 1,
    "pow": 1, "integer_pow": 1,
    "tanh": 1, "sin": 1, "cos": 1, "tan": 1, "atan2": 1,
    "erf": 1, "erfc": 1, "erf_inv": 1,
    "logistic": 1, "floor": 1, "ceil": 1, "round": 1,
    "nextafter": 1, "square": 1,
}

#: elementwise aten ops -> the primitives of the policy they count as
_ELEMENTWISE = {
    "add": ("add",), "sub": ("sub",), "rsub": ("sub",), "mul": ("mul",),
    "div": ("div",), "neg": ("neg",), "reciprocal": ("div",),
    "maximum": ("max",), "minimum": ("min",), "fmax": ("max",), "fmin": ("min",),
    "clamp_min": ("max",), "clamp_max": ("min",),
    "remainder": ("rem",), "fmod": ("rem",),
    "addcmul": ("mul", "add"), "addcdiv": ("div", "add"),
    "exp": ("exp",), "exp2": ("exp2",), "log": ("log",), "log1p": ("log1p",),
    "expm1": ("expm1",), "sqrt": ("sqrt",), "rsqrt": ("rsqrt",),
    "pow": ("pow",), "square": ("square",),
    "tanh": ("tanh",), "sin": ("sin",), "cos": ("cos",), "tan": ("tan",),
    "atan2": ("atan2",), "erf": ("erf",), "erfc": ("erfc",), "erfinv": ("erf_inv",),
    "sigmoid": ("logistic",), "floor": ("floor",), "ceil": ("ceil",),
    "round": ("round",), "nextafter": ("nextafter",),
}

#: reductions: aten op -> (primitive, ops per input element)
_REDUCTIONS = {
    "sum": ("reduce_sum", 1), "nansum": ("reduce_sum", 1), "mean": ("reduce_sum", 1),
    "amax": ("reduce_max", 1), "amin": ("reduce_min", 1), "prod": ("reduce_prod", 1),
    "argmax": ("argmax", 1), "argmin": ("argmin", 1),
    "cumsum": ("cumsum", 1), "logcumsumexp": ("cumlogsumexp", 2),
    "cummax": ("cummax", 1), "cummin": ("cummin", 1), "cumprod": ("cumprod", 1),
}

#: matrix products whose FLOPs are 2*M*N*K
_PRODUCTS = ("mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv")


@dataclass
class FlopCensus:
    """Result of :func:`flop_census`."""

    #: total FLOPs under the module policy
    flops: int = 0
    #: FLOPs by primitive name (same policy)
    by_primitive: Counter = field(default_factory=Counter)
    #: always False: eager PyTorch has no while loop (see the module doc)
    has_while: bool = False
    #: aten ops with no weight rule (counted as 0), by name, with the
    #: elements they produced -- data movement and predicates by design
    unweighted: Counter = field(default_factory=Counter)

    def add(self, prim: str, n: int) -> None:
        self.flops += n
        self.by_primitive[prim] += n


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _out_numel(out) -> int:
    if isinstance(out, (tuple, list)):
        return max((_numel(o) for o in out), default=0)
    return _numel(out)


def _product_flops(name: str, args, out) -> int:
    """2*M*N*K of a matrix product: output elements times twice the
    contracted length (the last axis of the left operand)."""
    lhs = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    return 2 * _out_numel(out) * int(lhs.shape[-1])


def _conv_flops(args, out) -> tuple:
    """(multiply-adds x 2, bias adds) of aten.convolution(input, weight,
    bias, ...): each output element takes in_channels / groups x kernel
    taps multiply-adds."""
    weight, bias = args[1], args[2]
    macs = _out_numel(out) * int(math.prod(weight.shape[1:]))
    return 2 * macs, (_out_numel(out) if bias is not None else 0)


class _Counting(TorchDispatchMode):
    def __init__(self, census: FlopCensus):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.census
        name = func.overloadpacket.__name__.rstrip("_")
        overload = func._overloadname
        if name in ("max", "min") and overload in ("other", "out"):
            c.add(name, _out_numel(out))
        elif name in ("max", "min"):  # the reductions max(x) / max(x, dim)
            c.add("reduce_" + name, _numel(args[0]))
        elif name in _REDUCTIONS:
            prim, w = _REDUCTIONS[name]
            c.add(prim, w * _numel(args[0]))
            if name == "mean":
                c.add("div", _out_numel(out))
        elif name in _PRODUCTS:
            c.add("dot_general", _product_flops(name, args, out))
            if name in ("addmm", "baddbmm", "addmv"):
                c.add("add", _out_numel(out))
        elif name == "convolution":
            macs2, bias = _conv_flops(args, out)
            c.add("conv", macs2)
            if bias:
                c.add("add", bias)
        elif name == "clamp":  # a max for a lower bound, a min for an upper one
            lo, hi = (list(args[1:3]) + [None, None])[:2]
            kw = kwargs or {}
            for prim, bound in (("max", kw.get("min", lo)), ("min", kw.get("max", hi))):
                if bound is not None:
                    c.add(prim, _out_numel(out))
        elif name in _ELEMENTWISE:
            for prim in _ELEMENTWISE[name]:
                c.add(prim, FLOP_WEIGHTS[prim] * _out_numel(out))
        else:
            c.unweighted[name] += _out_numel(out)
        return out


def flop_census(fn, *example_args) -> FlopCensus:
    """Count the FLOPs one call of ``fn(*example_args)`` performs, by running
    it once under the module counting policy (on the device its tensors
    lie on; the result of the call is discarded)."""
    out = FlopCensus()
    with torch.no_grad(), _Counting(out):
        fn(*example_args)
    return out
