"""HURRY core of the port: crossbar model, FB scheduling, chip simulator.

  crossbar          — ``CrossbarConfig``, the symmetric int8 quantizers
                      and the bit-sliced functional GEMM (the numeric
                      oracle, with read noise)
  workload          — ``LayerSpec`` and the GEMM-group iterator
  functional_blocks — FB requests and their cycle models
  scheduling        — Algorithms 1 & 2 + sequence-pair decoding
  bas               — the Block Activation Scheme's array concurrency
  area, energy,
  execution         — the analytical model's ledgers and execution engine
  simulator         — ``ChipConfig`` and the end-to-end HURRY chip model
  baselines         — ISAAC(-128/256/512) and MISCA
"""

from .bas import ArrayConfig, ArraySchedule, check_legal, schedule_array
from .baselines import BaselineConfig, simulate_isaac, simulate_misca
from .crossbar import (CrossbarConfig, crossbar_linear, crossbar_matmul,
                       dequant_scale, quantize_scale, quantize_symmetric)
from .functional_blocks import FBRequest, FunctionalBlock
from .scheduling import (ArrayPlan, balance_feasible, decode_sequence_pair,
                         fb_relative_positioning, fb_size_balancing,
                         place_fbs, plan_array)
from .simulator import (ChipConfig, SimReport, build_group_requests,
                        simulate_hurry)
from .workload import WORKLOADS, LayerSpec, layer_groups

__all__ = [
    "CrossbarConfig", "crossbar_matmul", "crossbar_linear",
    "quantize_symmetric", "quantize_scale", "dequant_scale",
    "FBRequest", "FunctionalBlock",
    "ArrayPlan", "fb_relative_positioning", "fb_size_balancing",
    "decode_sequence_pair", "place_fbs", "plan_array", "balance_feasible",
    "ArrayConfig", "ArraySchedule", "schedule_array", "check_legal",
    "ChipConfig", "SimReport", "simulate_hurry", "build_group_requests",
    "BaselineConfig", "simulate_isaac", "simulate_misca",
    "WORKLOADS", "LayerSpec", "layer_groups",
]
