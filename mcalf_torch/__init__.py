"""MC-ALF-Torch: the PyTorch/CUDA port of the MC-ALF-TPU absorption-line
fitter.

The package mirrors :mod:`mcalf_tpu` module by module (``ops``, ``models``,
``sampler``, ``runner``, ``cli``).  Plain tensor code is PyTorch, run
eagerly; the fused likelihood is a hand-written CUDA kernel for Hopper
(``csrc/fused_loglike.cu``, bound in :mod:`mcalf_torch.ops.voigt_cuda`).
Everything is float32, as in the JAX package.

The config parser, atomic database, spectrum/chain IO and chain analysis
are imported from :mod:`mcalf_tpu` (those modules need no jax); nothing in
this package imports jax.
"""

import torch

__version__ = "0.1.0"

# Float32 means float32: TF32 would keep ~3 decimal digits in matrix
# products (survivor covariances, whitened directions) and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["__version__"]
