from mcalf_torch.models.forward import AbsorptionModel, CCGS, CLIGHT_KMS, TAU_CONST
from mcalf_torch.models.torch_model import (
    StackedForward,
    TorchForward,
    make_stacked_forward,
    make_torch_forward,
)

__all__ = [
    "AbsorptionModel",
    "StackedForward",
    "TorchForward",
    "make_stacked_forward",
    "make_torch_forward",
    "CCGS",
    "CLIGHT_KMS",
    "TAU_CONST",
]
