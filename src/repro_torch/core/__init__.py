"""HURRY core of the port: crossbar numerics, layer specs, FB scheduling.

  crossbar          — ``CrossbarConfig`` and the symmetric int8 quantizers
  workload          — ``LayerSpec`` and the GEMM-group iterator
  functional_blocks — FB requests and their cycle models
  scheduling        — Algorithms 1 & 2 + sequence-pair decoding
  simulator         — ``ChipConfig`` and the per-group FB requests
"""

from .crossbar import (CrossbarConfig, dequant_scale, quantize_scale,
                       quantize_symmetric)
from .functional_blocks import FBRequest, FunctionalBlock
from .scheduling import ArrayPlan, plan_array
from .simulator import ChipConfig, build_group_requests
from .workload import LayerSpec, layer_groups

__all__ = [
    "CrossbarConfig", "dequant_scale", "quantize_scale",
    "quantize_symmetric", "FBRequest", "FunctionalBlock", "ArrayPlan",
    "plan_array", "ChipConfig", "build_group_requests", "LayerSpec",
    "layer_groups",
]
