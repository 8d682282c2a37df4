"""repro_torch.core — CIM-based TPU architecture model + simulator (the
paper).  Its cycles, TOPS and joules model the paper's TPU; they are not
measurements of the card the port runs on.

Public API:
    hardware presets  : get_hardware, tpuv4i_baseline, cim_tpu, design_a/b
    op IR             : MatMulOp, VectorOp, Graph, OpKind
    timing models     : matmul_cost (systolic vs CIM-MXU)
    simulation        : simulate_op / simulate_graph
    workloads         : gpt3_30b, dit_xl2, llm_*_graph, dit_graph
    exploration       : run_exploration, pick_designs (Table IV, Designs A/B)
    multichip         : tensor/pipeline parallel costs (Fig 8)
"""
from .energy import DEFAULT_ENERGY_MODEL, EnergyModel, mxu_area_mm2
from .explore import (ScenarioCost, dit_inference_cost, llm_decode_cost,
                      llm_inference_cost, llm_prefill_cost, pick_designs,
                      run_exploration)
from .hardware import (CIMCoreConfig, CIMMXUConfig, SystolicMXUConfig,
                       TPUConfig, VPUConfig, cim_tpu, design_a, design_b,
                       exploration_configs, get_hardware, tpu_v5e_target,
                       tpuv4i_baseline, PRESETS)
from .mapping import Mapping, map_matmul
from .multichip import (MultiChipCost, pipeline_parallel_dit_cost,
                        pipeline_parallel_llm_cost, tensor_parallel_llm_cost)
from .mxu_model import MXUCost, cim_cost, matmul_cost, systolic_cost
from .operators import (Graph, MatMulOp, Op, OpKind, VectorOp,
                        ATTENTION_BUCKET, GEMM_BUCKET)
from .simulator import (Bottleneck, GraphCost, OpCost, simulate_graph,
                        simulate_matmul, simulate_op, simulate_vector)
from .workloads import (ModelSpec, TransformerLayerSpec, dit_block_ops,
                        dit_graph, dit_tokens, dit_xl2, embed_head_graph,
                        gpt3_30b, llm_decode_graph, llm_prefill_graph,
                        transformer_layer_ops)

__all__ = [n for n in dir() if not n.startswith("_")]
