from mcalf_torch.ops.convolve import gaussian_kernel, kernel_half_size, lsf_convolve
from mcalf_torch.ops.faddeeva import (
    dawsn,
    hjert_harris,
    hjert_harris_win,
    hjert_wing,
)
from mcalf_torch.ops.voigt_cuda import fused_loglike, fused_loglike_plain

__all__ = [
    "dawsn",
    "hjert_harris",
    "hjert_harris_win",
    "hjert_wing",
    "gaussian_kernel",
    "kernel_half_size",
    "lsf_convolve",
    "fused_loglike",
    "fused_loglike_plain",
]
