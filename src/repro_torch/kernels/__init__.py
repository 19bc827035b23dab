"""Hand-written Hopper kernels of the port, each beside its plain version.

``crossbar_gemm`` (CUDA C++, ``csrc/crossbar_gemm.cu``) and
``fb_epilogue`` (CUDA C++, ``csrc/fb_epilogue.cu``) replace the two
Pallas kernels on the main path.  For a CUDA tensor a wrapper launches
its kernel (built with ``nvcc`` for ``sm_90a`` at first use, see
``_build``) and counts the launch in ``<wrapper>.launches``; for a CPU
tensor it computes the plain PyTorch version.
"""

from .crossbar_gemm import (clip_possible, crossbar_gemm, crossbar_gemm_ref,
                            crossbar_gemm_exact_ref)
from .fb_epilogue import (LN_EPS, fb_epilogue, fb_epilogue_ref, gelu,
                          layer_norm_rows, softmax_rows)

__all__ = [
    "clip_possible", "crossbar_gemm", "crossbar_gemm_ref",
    "crossbar_gemm_exact_ref", "LN_EPS", "fb_epilogue", "fb_epilogue_ref",
    "gelu", "layer_norm_rows", "softmax_rows",
]
