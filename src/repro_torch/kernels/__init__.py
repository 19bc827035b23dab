"""Hand-written Hopper kernels of the port, each beside its plain version.

One CUDA C++ kernel for each of the JAX package's five Pallas kernels,
under ``csrc/``: ``crossbar_gemm`` and ``fb_epilogue`` carry the
program's stages (also batched over attention's (batch, head) slices),
``flash_attention``, ``fused_gemm_epilogue`` and ``packed_gemm`` sit
behind the public wrappers in ``ops``.  A sixth, ``quantize_layout``,
ports no Pallas kernel but XLA's fusion of the JAX executor's im2col,
quantize and pad: it makes each stage's left operand for
``crossbar_gemm``.  For a CUDA tensor a wrapper launches its kernel
(built with ``nvcc`` for ``sm_90a`` at first use, see ``_build``) and
counts the launch in ``launches.<wrapper>`` (``repro_torch.trace``,
where a captured CUDA graph's replays add to the same counters); for a
CPU tensor it computes the plain PyTorch version.
"""

from .crossbar_gemm import (clip_possible, crossbar_gemm, crossbar_gemm_ref,
                            crossbar_gemm_exact_ref, kernel_layout,
                            mount_weight)
from .fb_epilogue import (LN_EPS, fb_epilogue, fb_epilogue_ref, gelu,
                          layer_norm_rows, softmax_rows)
from .flash_attention import (flash_attention, flash_attention_ref,
                              flash_attention_split_ref)
from .fused_gemm_epilogue import fused_gemm_epilogue, fused_gemm_epilogue_ref
from .packed_gemm import (packed_gemm, packed_gemm_ref, packed_gemm_tiles_ref,
                          pad_groups, tile_group_map)
from .quantize_layout import quantize_layout, quantize_layout_ref

__all__ = [
    "clip_possible", "crossbar_gemm", "crossbar_gemm_ref",
    "crossbar_gemm_exact_ref", "kernel_layout", "mount_weight",
    "LN_EPS", "fb_epilogue", "fb_epilogue_ref",
    "gelu", "layer_norm_rows", "softmax_rows", "flash_attention",
    "flash_attention_ref", "flash_attention_split_ref",
    "fused_gemm_epilogue", "fused_gemm_epilogue_ref",
    "packed_gemm", "packed_gemm_ref", "packed_gemm_tiles_ref", "pad_groups",
    "quantize_layout", "quantize_layout_ref", "tile_group_map",
]
