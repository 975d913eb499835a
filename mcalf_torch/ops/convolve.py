"""Gaussian line-spread-function convolution on torch tensors.

Port of :mod:`mcalf_tpu.ops.convolve`, with the same three boundary
semantics:

* ``'wrap'`` -- circular (the numpy/plot/mock path);
* ``'same'`` -- zero-padded;
* ``'same_edge'`` -- zero-padded, with the ``half`` edge pixels on each
  side reset to the unconvolved input (the likelihood path, and the
  convolution the fused kernel computes).

The kernel may differ per sample (floating ``specres``): it is a shifted
slice multiply-add over the K taps, in the same tap order as the JAX
version.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FWHM_TO_SIGMA",
    "SUPPORT_SIGMAS",
    "kernel_half_size",
    "gaussian_kernel",
    "lsf_convolve",
]

#: FWHM -> sigma conversion (reference hires_fitter.py:454)
FWHM_TO_SIGMA = 2.354820
#: Gaussian support radius in sigmas (reference hires_fitter.py:456-459)
SUPPORT_SIGMAS = 3.0348


def kernel_half_size(max_fwhm_kms: float, velstep_kms: float) -> int:
    """Static kernel half-width in pixels for the largest admissible FWHM."""
    sigma_max = (float(max_fwhm_kms) / FWHM_TO_SIGMA) / float(velstep_kms)
    return int(np.ceil(SUPPORT_SIGMAS * sigma_max))


def gaussian_kernel(sigma_pix: torch.Tensor, half_size: int) -> torch.Tensor:
    """Point-sampled normalized Gaussian, shape (..., 2*half_size+1)."""
    sigma_pix = torch.as_tensor(sigma_pix)
    x = torch.arange(
        -half_size, half_size + 1, dtype=sigma_pix.dtype, device=sigma_pix.device
    )
    k = torch.exp(-(x**2) / (2.0 * sigma_pix[..., None] ** 2))
    return k / torch.sum(k, dim=-1, keepdim=True)


def lsf_convolve(flux: torch.Tensor, kernel: torch.Tensor, mode: str = "same_edge"):
    """Convolve (..., P) spectra with (K,) or (..., K) symmetric kernels,
    K = 2*half+1 odd.  Returns (..., P)."""
    K = kernel.shape[-1]
    if K % 2 != 1:
        raise ValueError("kernel size must be odd")
    half = K // 2
    P = flux.shape[-1]

    if mode == "wrap":
        idx = torch.arange(-half, P + half, device=flux.device) % P
        padded = flux[..., idx]
    elif mode in ("same", "same_edge"):
        padded = F.pad(flux, (half, half))
    else:
        raise ValueError(f"unknown convolution mode {mode!r}")

    acc = kernel[..., 0:1] * padded[..., 0:P]
    for k in range(1, K):
        acc = acc + kernel[..., k : k + 1] * padded[..., k : k + P]

    if mode == "same_edge":
        idx = torch.arange(P, device=flux.device)
        edge = (idx < half) | (idx >= P - half)
        acc = torch.where(edge, flux, acc)
    return acc
