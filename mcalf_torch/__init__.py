"""MC-ALF-Torch: the PyTorch/CUDA port of the MC-ALF-TPU absorption-line
fitter.

The package mirrors :mod:`mcalf_tpu` module by module (``config``,
``atomic``, ``io``, ``ops``, ``models``, ``sampler``, ``runner``, ``cli``).
Plain tensor code is PyTorch, run eagerly; the Voigt optical depth and the
fused likelihood are hand-written CUDA kernels for Hopper (``csrc/``, bound
in :mod:`mcalf_torch.ops.voigt_cuda`).  Everything is float32, as in the
JAX package.

The package imports neither jax nor anything of :mod:`mcalf_tpu`: the host
modules it needs (config parser, atomic database, spectrum and chain IO)
are copies of the JAX package's, held equal to them by the tests.
"""

import torch

__version__ = "0.1.0"

# Float32 means float32: TF32 would keep ~3 decimal digits in matrix
# products (survivor covariances, whitened directions) and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["__version__"]
