"""The front-door session object: ``api.compile(...) -> CompiledModel``.

The port of ``repro.api.model``'s compile-and-run path::

    model = api.compile("resnet18", HurryConfig())   # on the GPU
    probs = model.run(x)                              # x: (B, 32, 32, 3)
    logits = model.run(x, logits=True)
    vit = api.compile("vit_tiny")                     # attention stages too
    tokens = api.compile(graph_with_input_seq_dim)    # x: (B, T, D)

``compile`` lowers the graph (Algorithms 1 & 2 -> ``CrossbarProgram``)
and packs the weights once, on the model's device; ``run`` only
quantizes activations and launches one ``crossbar_gemm`` and one
``fb_epilogue`` per stage, the attention stages' per-(batch, head)
mounts included.  Batches pad up to the bucket ladder by edge
replication (slice-exact).  The device is ``"cuda"`` unless the caller
names another; without a GPU ``compile`` raises rather than carry on on
the CPU.  ``simulate``/``save``/``load`` are not part of the port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.program.compile import CrossbarProgram, compile_network
from repro_torch.program.execute import execute_packed
from repro_torch.program.pack import PackedProgram, pack_program
from repro_torch.program.serve import BUCKETS, bucket_batch, pad_batch

from .config import HurryConfig
from .graph import NetworkBuilder, NetworkGraph
from .zoo import GRAPHS


def _as_param(t, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array-like."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises when a CUDA device is asked for and none is present: the
    port never carries on on the CPU unless told to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@dataclasses.dataclass
class CompiledModel:
    """A compiled + packed network, runnable on its device."""

    graph: NetworkGraph
    config: HurryConfig
    program: CrossbarProgram
    params: dict
    packed: PackedProgram
    device: torch.device
    buckets: tuple[int, ...] = BUCKETS

    def run(self, x, *, logits: bool = False) -> torch.Tensor:
        """Execute the packed program on a batch (array or tensor).

        Returns the program's output buffer on the model's device
        (softmax probabilities when the graph ends in softmax);
        ``logits=True`` returns the last GEMM output.
        """
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        b = x.shape[0]
        x = pad_batch(x, bucket_batch(b, self.buckets))
        return execute_packed(self.packed, x, return_logits=logits)[:b]

    def warmup(self, batch: int = 1, *, logits: bool = False,
               seq_len: int = 16) -> None:
        """Run one dummy batch (builds the kernels on a GPU); ``seq_len``
        sizes the token axis of sequence-input graphs."""
        x = torch.zeros(self.program.input_shape(batch, seq_len=seq_len),
                        device=self.device)
        self.run(x, logits=logits)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summary(self) -> str:
        cfg = self.program.cfg
        return "\n".join([
            f"CompiledModel({self.graph.name}) on {self.device}: "
            f"{len(self.graph.layers)} layers, input "
            f"{self.program.input_shape(1)[1:]}, "
            f"{cfg.rows}x{cfg.cols} arrays / {cfg.adc_bits}-bit ADC"
            f"{' (clip-free)' if cfg.clip_free else ''}",
            self.program.summary()])


def compile(network, config: HurryConfig | None = None, *,
            params: dict | None = None, seed: int = 0,
            buckets: tuple[int, ...] | None = BUCKETS,
            device=None) -> CompiledModel:
    """Lower a network to a ``CompiledModel`` under one unified config.

    ``network`` is a ``NetworkGraph``, a ``NetworkBuilder``, a registry
    name (``zoo.GRAPHS``) or a raw ``LayerSpec`` list.  ``params``
    (layer -> key -> tensor or array, the JAX package's layouts)
    defaults to ``graph.init_params`` drawn from a generator seeded with
    ``seed``.  ``device`` defaults to ``"cuda"`` (``resolve_device``).
    """
    dev = resolve_device(device)
    config = config or HurryConfig()
    if isinstance(network, str):
        graph = GRAPHS[network]()
    elif isinstance(network, NetworkBuilder):
        graph = network.build()
    elif isinstance(network, NetworkGraph):
        graph = network
    else:
        graph = NetworkGraph.from_layers(network)
    program = compile_network(graph, config=config)
    if params is None:
        params = graph.init_params(torch.Generator().manual_seed(seed))
    params = {k: {n: _as_param(t, dev) for n, t in p.items()}
              for k, p in params.items()}
    return CompiledModel(graph=graph, config=config, program=program,
                         params=params, packed=pack_program(program, params),
                         device=dev, buckets=tuple(buckets or ()))
