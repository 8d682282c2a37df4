"""Hand-written CUDA kernels for the port and their plain versions.

Each kernel wrapper counts its launches in a ``launches`` attribute;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets
them to zero (``chip_smoke.py`` uses both to show which kernels a run
went through).  ``online_softmax`` takes the launches its
``softmax_plan`` gives: one, or two for a row longer than a
thread-block cluster holds (a stats and a normalize launch), and counts
both.  ``finite_screen`` (the degraded mode's screen) launches only under
``quant.degraded_mode``.
"""
from . import (cim_gemm, decode_attention, flash_attention, online_softmax,
               ops, ref, ssd_scan)

KERNELS = {
    "quantize_rows_int8": cim_gemm.quantize_rows_int8,
    "cim_gemm_int8_fused_qin": cim_gemm.cim_gemm_int8_fused_qin,
    "cim_gemm_int8_fused": cim_gemm.cim_gemm_int8_fused,
    "cim_gated_gemm_int8": cim_gemm.cim_gated_gemm_int8,
    "cim_grouped_gemm_int8": cim_gemm.cim_grouped_gemm_int8,
    "cim_grouped_gated_gemm_int8": cim_gemm.cim_grouped_gated_gemm_int8,
    "cim_gemm_int8": cim_gemm.cim_gemm_int8,
    "finite_screen": cim_gemm.finite_screen,
    "decode_attention": decode_attention.decode_attention,
    "decode_attention_paged": decode_attention.decode_attention_paged,
    "decode_attention_partial": decode_attention.decode_attention_partial,
    "decode_attention_combine": decode_attention.decode_attention_combine,
    "flash_attention": flash_attention.flash_attention,
    "ssd_scan": ssd_scan.ssd_scan,
    "online_softmax": online_softmax.online_softmax,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["cim_gemm", "decode_attention", "flash_attention",
           "online_softmax", "ops", "ref", "ssd_scan", "KERNELS",
           "launch_counts", "reset_launch_counts"]
