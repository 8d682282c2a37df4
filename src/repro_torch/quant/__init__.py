from .linear import (QuantizedLinear, kernel_mode, quantize_attention,
                     quantize_linear, quantize_mlp, quantized_matmul,
                     quantized_mlp_apply, quantized_out_proj,
                     quantized_qkv_proj)
from .plan import (FULL_INT8, LAYER_KINDS, QuantPlan, apply_plan,
                   covered_kinds)

__all__ = ["QuantizedLinear", "kernel_mode", "quantize_attention",
           "quantize_linear", "quantize_mlp", "quantized_matmul",
           "quantized_mlp_apply", "quantized_out_proj",
           "quantized_qkv_proj", "FULL_INT8", "LAYER_KINDS", "QuantPlan",
           "apply_plan", "covered_kinds"]
