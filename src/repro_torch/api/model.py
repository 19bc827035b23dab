"""The front-door session object: ``api.compile(...) -> CompiledModel``.

The port of ``repro.api.model``::

    model = api.compile("resnet18", HurryConfig())   # on the GPU
    probs = model.run(x)                              # x: (B, 32, 32, 3)
    logits = model.run(x, logits=True)
    report = model.simulate("isaac-128")              # cycles/energy/area
    model.save("model.npz"); m2 = api.load("model.npz")   # skip compile
    vit = api.compile("vit_tiny")                     # attention stages too
    tokens = api.compile(graph_with_input_seq_dim)    # x: (B, T, D)

``compile`` lowers the graph (Algorithms 1 & 2 -> ``CrossbarProgram``)
and packs the weights once, on the model's device; ``run`` only
quantizes activations and launches one ``crossbar_gemm`` and one
``fb_epilogue`` per stage, the attention stages' per-(batch, head)
mounts included.  Batches pad up to the bucket ladder by edge
replication (slice-exact).  On a GPU, as the JAX package jits one
executable per bucket, ``run`` captures ``execute_packed`` as a CUDA
graph at the first request of each (bucket, flavor, input shape) and
replays it for every later one (``program.serve.Executable``;
``warmup`` captures ahead of traffic); the kernels' launch counters
count the replayed launches.  On the CPU ``run`` is eager.
``simulate`` runs the analytical chip model on the same graph;
``save``/``load`` persist the packed planes in the JAX package's file
format, so a file written by either package loads in the other.  The device is ``"cuda"`` unless the caller names another;
without a GPU ``compile`` and ``load`` raise rather than carry on on the
CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.core.baselines import (SimReport, simulate_isaac,
                                        simulate_misca)
from repro_torch.core.simulator import simulate_hurry
from repro_torch.core.workload import SEQ_KINDS
from repro_torch.device import resolve_device
from repro_torch.program.compile import CrossbarProgram, compile_network
from repro_torch.program.pack import PackedProgram, pack_program
from repro_torch.program.serve import BUCKETS, params_to, run_bucketed

from .config import HurryConfig
from .graph import NetworkBuilder, NetworkGraph
from .serialize import load_model, save_model
from .zoo import GRAPHS

SIM_ARCHS = ("hurry", "isaac-128", "isaac-256", "isaac-512", "misca")


@dataclasses.dataclass
class CompiledModel:
    """A compiled + packed network: runnable on its device, simulatable,
    persistable."""

    graph: NetworkGraph
    config: HurryConfig
    program: CrossbarProgram
    params: dict
    packed: PackedProgram
    device: torch.device
    buckets: tuple[int, ...] = BUCKETS
    _fns: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def run(self, x, *, logits: bool = False) -> torch.Tensor:
        """Execute the packed program on a batch (array or tensor).

        Returns a new tensor on the model's device: the program's output
        buffer (softmax probabilities when the graph ends in softmax);
        ``logits=True`` returns the last GEMM output.  Batches pad up to
        the model's bucket ladder; on a GPU each (bucket, flavor, input
        shape) is captured once as a CUDA graph and replayed after
        (``_fns``, the counterpart of the JAX model's executables).
        """
        return run_bucketed(self.packed, x, device=self.device,
                            buckets=self.buckets, fns=self._fns,
                            return_logits=logits)

    def warmup(self, batch: int = 1, *, logits: bool = False,
               seq_len: int = 16) -> None:
        """Pay the set-up of one batch bucket ahead of traffic: on a GPU
        build the kernels and capture that bucket's graph (the
        counterpart of JAX's trace + compile); on the CPU run the batch
        once.  ``seq_len`` sizes the token axis of sequence-input graphs
        (a key of its own per length)."""
        x = torch.zeros(self.program.input_shape(batch, seq_len=seq_len),
                        device=self.device)
        self.run(x, logits=logits)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def simulate(self, arch: str = "hurry") -> SimReport:
        """Cycle/energy/area report for this graph on ``arch``.

        ``arch`` is one of ``SIM_ARCHS``: the HURRY chip this model was
        compiled for, or an ISAAC/MISCA comparison chip sharing its
        geometry.  Pure Python on the host; the device plays no part.
        """
        if arch not in SIM_ARCHS:
            raise ValueError(f"unknown arch {arch!r}; one of {SIM_ARCHS}")
        if any(l.kind in SEQ_KINDS for l in self.graph.layers):
            raise ValueError(
                f"{self.graph.name}: the analytical chip model does not "
                "cover sequence workloads yet (dynamic-operand mounts "
                "have no Algorithm 1/2 placement); numeric execution "
                "via .run() is fully supported")
        layers = list(self.graph.layers)
        if arch == "hurry":
            return simulate_hurry(layers, chip=self.config.chip(),
                                  name=f"hurry/{self.graph.name}")
        if arch == "misca":
            return simulate_misca(layers, chip=self.config)
        return simulate_isaac(layers, int(arch.split("-")[1]),
                              chip=self.config)

    def summary(self) -> str:
        cfg = self.program.cfg
        return "\n".join([
            f"CompiledModel({self.graph.name}) on {self.device}: "
            f"{len(self.graph.layers)} layers, input "
            f"{self.program.input_shape(1)[1:]}, "
            f"{cfg.rows}x{cfg.cols} arrays / {cfg.adc_bits}-bit ADC"
            f"{' (clip-free)' if cfg.clip_free else ''}",
            self.program.summary()])

    def save(self, path: str) -> str:
        """Persist program + params + packed planes (``save_model``):
        loading skips both compilation and weight quantization."""
        return save_model(self, path)


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
    with trace.span("compile"):
        with trace.span("compile.lower"):
            if isinstance(network, str):
                graph = GRAPHS[network]()
            elif isinstance(network, NetworkBuilder):
                graph = network.build()
            elif isinstance(network, NetworkGraph):
                graph = network
            else:
                graph = NetworkGraph.from_layers(network)
            program = compile_network(graph, config=config)
        with trace.span("compile.params"):
            if params is None:
                params = graph.init_params(torch.Generator().manual_seed(
                    seed))
            params = params_to(params, dev)
        with trace.span("compile.pack"):
            packed = pack_program(program, params)
    return CompiledModel(graph=graph, config=config, program=program,
                         params=params, packed=packed,
                         device=dev, buckets=tuple(buckets or ()))


def load(path: str, *, device=None) -> CompiledModel:
    """Load a ``CompiledModel`` saved by ``save`` (by either package) onto
    ``device`` (default ``"cuda"``): no compilation happens."""
    return load_model(path, device=resolve_device(device))
