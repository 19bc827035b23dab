"""Deterministic synthetic data pipeline with skip-ahead.

The port of ``repro.data.pipeline``.  An infinite, seeded token stream
where batch ``i`` is a pure function of (seed, i) — so any worker, after
restart or elastic rescale, regenerates exactly the batches it needs
without replaying the stream (``state()``/``from_state`` round-trips
through the checkpoint).  On a real cluster each data-parallel host
materializes only its shard (``host_slice``).  The tokens are drawn with
numpy exactly as the JAX package draws them, so both packages see the
same batches; they land on ``device`` (default: the GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def batch_at(self, step: int) -> dict:
        """Batch ``step`` as a pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = rng.integers(0, self.vocab_size,
                            (self.batch, self.seq_len), dtype=np.int32)
        # inject learnable structure: periodic copy pattern
        toks[:, 1::2] = (toks[:, 0::2] + 1) % self.vocab_size
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b

    def host_slice(self, batch: dict, host_id: int, n_hosts: int) -> dict:
        per = self.batch // n_hosts
        return tree_map(lambda x: x[host_id * per:(host_id + 1) * per],
                        batch)

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, vocab_size: int, batch: int, seq_len: int,
                   state: dict, device=None) -> "TokenPipeline":
        return cls(vocab_size, batch, seq_len, seed=state["seed"],
                   step=state["step"], device=device)
