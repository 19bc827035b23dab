"""Batch-size buckets for serving: pad a request batch by edge replication.

The port of ``repro.program.serve``'s bucketing helpers.  Incoming
batches are padded up to a small ladder of bucket sizes and the output
is sliced back.  Replicating the last request (rather than zero-filling)
keeps every per-tensor quantization max exact, so the kept rows of a
bucketed run are bit-identical to an unpadded run.  ``ProgramServer`` /
``make_server`` are not part of the port yet (``api.CompiledModel``
serves).
"""

from __future__ import annotations

from typing import Sequence

import torch

# powers of two cover varying traffic with at most 2x padding
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def bucket_batch(b: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= b, or b itself beyond the ladder (exact shape)."""
    return min((s for s in buckets if s >= b), default=b)


def pad_batch(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad the batch axis up to ``bucket`` by replicating the last row."""
    b = x.shape[0]
    if bucket == b:
        return x
    return torch.cat([x, x[-1:].expand(bucket - b, *x.shape[1:])])
