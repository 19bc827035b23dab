"""Crossbar program subsystem of the port: compile, pack, execute.

``compile.py`` lowers a network through Algorithms 1 & 2 +
sequence-pair decoding into a static ``CrossbarProgram``; ``pack.py``
mounts the weights at compile time (int8 planes, conv layout, K padded
to full mounts); ``execute.py`` runs the packed program, one
``crossbar_gemm`` and one ``fb_epilogue`` call per stage; ``serve.py``
holds the batch-bucket helpers.
"""

from .compile import CrossbarProgram, MountRound, ProgramOp, compile_network
from .execute import execute_packed
from .pack import PackedProgram, PackedStage, pack_program
from .serve import BUCKETS, bucket_batch, pad_batch

__all__ = [
    "CrossbarProgram", "MountRound", "ProgramOp", "compile_network",
    "PackedProgram", "PackedStage", "pack_program", "execute_packed",
    "BUCKETS", "bucket_batch", "pad_batch",
]
