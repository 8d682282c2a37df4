from .linear import (QuantizedLinear, degraded_mode, kernel_mode,
                     quantize_attention,
                     quantize_linear, quantize_mlp, quantize_moe_experts,
                     quantized_matmul, quantized_mlp_apply,
                     quantized_moe_apply, quantized_moe_apply_looped,
                     quantized_out_proj, quantized_qkv_proj)
from .plan import (DIT_LAYER_KINDS, FULL_INT8, LAYER_KINDS, QuantPlan,
                   apply_dit_plan, apply_plan, covered_kinds)

__all__ = ["QuantizedLinear", "degraded_mode", "kernel_mode",
           "quantize_attention",
           "quantize_linear", "quantize_mlp", "quantize_moe_experts",
           "quantized_matmul", "quantized_mlp_apply", "quantized_moe_apply",
           "quantized_moe_apply_looped", "quantized_out_proj",
           "quantized_qkv_proj", "DIT_LAYER_KINDS", "FULL_INT8",
           "LAYER_KINDS", "QuantPlan", "apply_dit_plan", "apply_plan",
           "covered_kinds"]
