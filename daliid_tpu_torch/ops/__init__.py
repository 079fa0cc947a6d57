"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from daliid_tpu_torch.ops.flash_attention import flash_attention
from daliid_tpu_torch.ops.quantize import calibrate, quantized_apply

__all__ = ["flash_attention", "calibrate", "quantized_apply"]
