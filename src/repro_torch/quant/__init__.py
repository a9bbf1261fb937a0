"""Quantization substrate: symmetric PTQ quantizers + TransitiveLinear."""
from repro_torch.quant.quantize import (  # noqa: F401
    absmax_scale, dequantize_groupwise, fake_quant, quantize_groupwise,
    quantize_per_token)
from repro_torch.quant.qlinear import (  # noqa: F401
    QuantConfig, linear_init, linear_apply)
