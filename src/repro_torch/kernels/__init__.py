"""Hand-written CUDA kernels for the port and their plain versions.

Each kernel wrapper counts its launches in a ``launches`` attribute;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets
them to zero (``chip_smoke.py`` uses both to show which kernels a run
went through).
"""
from . import cim_gemm, decode_attention, ops, ref

KERNELS = {
    "quantize_rows_int8": cim_gemm.quantize_rows_int8,
    "cim_gemm_int8_fused_qin": cim_gemm.cim_gemm_int8_fused_qin,
    "cim_gemm_int8_fused": cim_gemm.cim_gemm_int8_fused,
    "cim_gated_gemm_int8": cim_gemm.cim_gated_gemm_int8,
    "cim_grouped_gemm_int8": cim_gemm.cim_grouped_gemm_int8,
    "cim_grouped_gated_gemm_int8": cim_gemm.cim_grouped_gated_gemm_int8,
    "decode_attention": decode_attention.decode_attention,
    "decode_attention_paged": decode_attention.decode_attention_paged,
    "decode_attention_partial": decode_attention.decode_attention_partial,
    "decode_attention_combine": decode_attention.decode_attention_combine,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["cim_gemm", "decode_attention", "ops", "ref", "KERNELS",
           "launch_counts", "reset_launch_counts"]
