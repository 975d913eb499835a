"""Stacking several fit problems into one set of constants with a problem axis.

Port of :mod:`mcalf_tpu.models.batched`.  Independent problems -- different
sightlines, different seeds of one sightline -- become a leading axis of the
constants (numpy, as :func:`~mcalf_torch.models.torch_model.build_consts`
gives them), and :class:`~mcalf_torch.models.torch_model.StackedForward`
evaluates rows of any of them in one fused-kernel launch.  All problems of a
stack share one :class:`StaticSpec` (ndim, npix, transitions, kernel
support, flags); pad spectra to a common grid with :func:`pad_model_to_npix`
(padded pixels carry zero inverse variance, so they add nothing to the
likelihood).

The JAX package's ``use_pallas`` switch has no counterpart here: the device
the constants are carried to picks the path (a CUDA device runs the kernel,
the CPU its plain version).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

from mcalf_torch.models.forward import AbsorptionModel
from mcalf_torch.models.torch_model import StaticSpec, build_consts, static_spec

__all__ = ["STATIC_KEYS", "stack_problems", "index_consts", "pad_model_to_npix"]

#: layout index tables, identical across stacked problems and kept unstacked
STATIC_KEYS = ("pidx", "comp_id", "is_fill", "u_zidx")


def stack_problems(
    models: Sequence[AbsorptionModel],
    conv_mode: str = "same_edge",
    gpriors: bool = False,
) -> Tuple[StaticSpec, Dict[str, Any]]:
    """Stack N fit problems into (shared StaticSpec, constants with leading
    axis N).  Raises ``ValueError`` if the problems are not structurally
    identical."""
    if not models:
        raise ValueError("need at least one model")
    specs = [static_spec(m, conv_mode=conv_mode, gpriors=gpriors) for m in models]
    s0 = specs[0]
    for i, s in enumerate(specs[1:], 1):
        if s != s0:
            raise ValueError(
                f"problem {i} has incompatible structure:\n  {s}\nvs\n  {s0}\n"
                "(pad spectra to a common pixel grid and use identical "
                "component/line configuration to stack)"
            )
    consts = [build_consts(m, gpriors=gpriors) for m in models]
    stacked = {k: np.stack([c[k] for c in consts], axis=0) for k in consts[0]}
    for k in STATIC_KEYS:
        stacked[k] = consts[0][k]
    return s0, stacked


def index_consts(stacked: Dict[str, Any], i) -> Dict[str, Any]:
    """Select problem ``i`` from stacked constants (static tables pass
    through)."""
    return {k: v if k in STATIC_KEYS else v[i] for k, v in stacked.items()}


def pad_model_to_npix(model: AbsorptionModel, npix: int) -> AbsorptionModel:
    """Pad a problem's spectrum to ``npix`` pixels with zero-weight pixels so
    structurally similar sightlines of different lengths can stack.

    Padded pixels extend the wavelength grid at the red end with the median
    *logarithmic* pixel spacing (constant velocity step, so the derived
    ``velstep`` -- and hence the LSF kernel -- is unchanged), carry flux=1
    and noise=inf (=> zero inverse variance and no likelihood
    contribution)."""
    cur = model.npix
    if cur > npix:
        raise ValueError(f"model has {cur} pixels > target {npix}")
    if cur == npix:
        return model
    extra = npix - cur
    ratio = float(np.median(model.obj_wl[1:] / model.obj_wl[:-1]))
    wave = np.concatenate(
        [model.obj_wl, model.obj_wl[-1] * ratio ** np.arange(1, extra + 1)]
    )
    flux = np.concatenate([model.obj, np.ones(extra)])
    noise = np.concatenate([model.obj_noise, np.full(extra, np.inf)])
    return AbsorptionModel(
        wave=wave,
        flux=flux,
        noise=noise,
        lines=model.lines,
        ncomp=(model.ncompmin, model.ncompmax),
        nfill=model.nfill,
        specres=model.specres,
        contval=model.contval,
        Nrange=model.Nrange,
        brange=model.brange,
        zrange=model.zrange,
        Nrangefill=model.Nrangefill,
        brangefill=model.brangefill,
        wrangefill=model.wrangefill,
        fitrange=None,  # arrays are already masked; keep as-is
        asymmlike=model.asymmlike,
        gpriors=model.gpriors,
    )
