"""Batched serving entry: compile + pack once, execute per request batch.

The port of ``repro.program.serve``.  ``make_server`` lowers the network
to a ``CrossbarProgram`` a single time and **packs the weights at
construction** on the server's device (``pack.pack_program``, the
numeric analogue of programming the chip's conductances), so each
``ProgramServer`` call only quantizes the input and launches one
``crossbar_gemm`` and one ``fb_epilogue`` per stage.

Incoming batches are padded up to a small ladder of **bucket sizes** and
the output is sliced back.  Replicating the last request (rather than
zero-filling) keeps every per-tensor quantization max exact, so the kept
rows of a bucketed run are bit-identical to an unpadded run.
``repro_torch.api.CompiledModel`` is the full-featured front door
(persistable, simulatable); it serves through the same ``run_bucketed``,
so a server and a model on the same packed program answer bit for bit
alike.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.simulator import ChipConfig
from repro_torch.device import resolve_device

from .compile import CrossbarProgram, compile_network
from .execute import execute_packed
from .pack import PackedProgram, pack_program

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


def params_to(params: dict, device: torch.device) -> dict:
    """``{layer: {key: tensor or array}}`` as float32 tensors on
    ``device``."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t, dtype=np.float32))
        return t.to(device=device, dtype=torch.float32)
    return {k: {n: one(t) for n, t in p.items()} for k, p in params.items()}


def run_bucketed(packed: PackedProgram, x, *, device: torch.device,
                 buckets: Sequence[int],
                 return_logits: bool = False) -> torch.Tensor:
    """Execute ``packed`` on a batch (array or tensor) on ``device``: pad
    it up to its bucket, run, and slice the padding off again."""
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    b = x.shape[0]
    x = pad_batch(x, bucket_batch(b, buckets))
    return execute_packed(packed, x, return_logits=return_logits)[:b]


@dataclasses.dataclass
class ProgramServer:
    """A compiled + packed network on its device, ready for batches."""

    program: CrossbarProgram
    params: dict
    packed: PackedProgram
    device: torch.device
    return_logits: bool = False
    buckets: tuple[int, ...] = BUCKETS

    def __call__(self, x) -> torch.Tensor:
        return run_bucketed(self.packed, x, device=self.device,
                            buckets=self.buckets,
                            return_logits=self.return_logits)

    def warmup(self, batch: int = 1) -> None:
        """Run one dummy batch (builds the kernels on a GPU).

        The dummy batch takes its shape from the compiled program's
        input spec, so warming up a non-CIFAR network runs the shapes
        that will actually serve it.
        """
        self(torch.zeros(self.program.input_shape(batch),
                         device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_server(net, params: dict | None = None, *,
                config=None,
                cfg: CrossbarConfig | None = None,
                chip: ChipConfig | None = None,
                return_logits: bool = False,
                buckets: Sequence[int] | None = BUCKETS,
                donate_input: bool = False,
                seed: int = 0, device=None) -> ProgramServer:
    """Compile ``net`` once, pack its weights, and wrap it for serving.

    ``config`` is a ``repro_torch.api.HurryConfig``: chip geometry and
    crossbar numerics derive from it (explicit ``cfg``/``chip`` still
    win).  ``params`` (layer -> key -> tensor or array, the JAX
    package's layouts) defaults to ``models.cnn``'s init of the named
    paper CNNs from a generator seeded with ``seed``.  ``buckets`` is the
    batch-size ladder (None or ``()`` disables bucketing).
    ``donate_input=True`` is the caller's promise, as in the JAX
    package, never to reuse a request batch after the call; the eager
    executor has no buffer to hand over, so the port accepts the
    promise and changes nothing.  ``device`` defaults to ``"cuda"``
    (``resolve_device``).
    """
    del donate_input            # accepted for parity; see the docstring
    dev = resolve_device(device)
    if config is not None:
        chip = chip or config.chip()
        cfg = cfg or config.crossbar()
    program = compile_network(net, chip=chip, cfg=cfg)
    if params is None:
        if not isinstance(net, str):
            raise ValueError("params are required for non-registry "
                             "networks (only the named paper CNNs have "
                             "a default init)")
        from repro_torch.models.cnn import CNN_MODELS   # lazy: models
        params = CNN_MODELS[net].init(torch.Generator().manual_seed(seed))
    params = params_to(params, dev)
    return ProgramServer(program=program, params=params,
                         packed=pack_program(program, params), device=dev,
                         return_logits=return_logits,
                         buckets=tuple(buckets or ()))
