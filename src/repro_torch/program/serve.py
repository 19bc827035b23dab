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

**One executable per key**, the counterpart of the JAX package's
``jax.jit`` executables: on a CUDA device the first request of a key
(padded batch bucket, output flavor, the rest of the input's shape;
``executable_key``) runs ``execute_packed`` once eagerly on a side
stream (the kernels build and set their launch attributes there), then
captures it as a ``torch.cuda.CUDAGraph`` over a static input buffer
(``Executable``); every request of that key copies its padded batch in,
replays the graph and returns a fresh copy of the kept output rows.
All graphs of one server or model share one memory pool.  A capture or
a replay that fails raises: nothing carries on eagerly on the card.  On
the CPU every request runs ``execute_packed`` eagerly.
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

from repro_torch import trace
from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.simulator import ChipConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import COUNTED

from .compile import CrossbarProgram, compile_network
from .execute import QUANTIZE_KERNELS, execute_packed
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


def executable_key(shape: Sequence[int], buckets: Sequence[int],
                   return_logits: bool) -> tuple:
    """The key of a request's executable: (padded batch bucket,
    ``return_logits``, the rest of the input's shape), as ``jax.jit``
    keys on the padded input's full shape (a token-input program's T
    included) and the flavor."""
    return (bucket_batch(shape[0], buckets), bool(return_logits),
            tuple(shape[1:]))


@dataclasses.dataclass
class Executable:
    """``execute_packed`` on one key, captured as a CUDA graph.

    ``x`` is the static input the graph reads and ``out`` the static
    output it writes (in the graph's memory pool ``pool``); both, and
    every intermediate of the capture, stay where they were captured:
    ``crossbar_gemm``'s TMA descriptors hold their addresses.
    ``launches`` is each counting wrapper's launches per replay (what
    the capture recorded), added to its counter on every replay, so the
    counters count the launches the device performs; ``capture_s`` is
    the host seconds of the eager warm-up and the capture (the
    ``capture`` span's clock).  ``plan`` is the replay's launch plan,
    stage by stage in order (``execute.PlanStep``: the layer, each
    wrapper's calls and their device kernels), and ``kernels`` its
    device kernels of ``quantize_layout``, added to the
    ``device_kernels.quantize_layout`` counter on every replay.
    """

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    out: torch.Tensor
    pool: tuple
    launches: dict
    capture_s: float
    plan: tuple = ()
    kernels: int = 0

    @classmethod
    def capture(cls, packed: PackedProgram, x: torch.Tensor, *,
                return_logits: bool, pool: tuple | None = None
                ) -> "Executable":
        """Warm ``execute_packed`` up on ``x`` (a padded CUDA batch) on a
        side stream, then capture it over a copy of ``x`` into ``pool``
        (a new pool when None).  The counters are put back as they were
        before the warm-up."""
        before = {fn: fn.launches for fn in COUNTED}
        kernels0 = trace.counters().get(QUANTIZE_KERNELS, 0)
        plan: list = []
        try:
            with trace.timed("capture") as timer, \
                    torch.cuda.device(x.device):
                static_x = x.clone()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with trace.span("capture.warm"), torch.cuda.stream(side):
                    execute_packed(packed, x, return_logits=return_logits)
                torch.cuda.current_stream().wait_stream(side)
                pool = pool or torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                start = {fn: fn.launches for fn in COUNTED}
                with trace.span("capture.graph"), torch.cuda.graph(
                        graph, pool=pool, capture_error_mode="thread_local"):
                    out = execute_packed(packed, static_x,
                                         return_logits=return_logits,
                                         plan=plan)
                launches = {fn: fn.launches - start[fn] for fn in COUNTED}
        finally:
            for fn, n in before.items():
                fn.launches = n
            trace.count(QUANTIZE_KERNELS,
                        kernels0 - trace.counters().get(QUANTIZE_KERNELS, 0))
        return cls(graph=graph, x=static_x, out=out, pool=pool,
                   launches=launches, capture_s=timer.seconds,
                   plan=tuple(plan),
                   kernels=sum(p.kernels.get("quantize_layout", 0)
                               for p in plan))

    def __call__(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """Replay on ``x`` (the key's padded batch): a new tensor holding
        the first ``rows`` rows of the output."""
        with trace.span("run.copy_in"):
            self.x.copy_(x)
        with trace.span("run.replay"):
            self.graph.replay()
            for fn, n in self.launches.items():
                fn.launches += n
            trace.count(QUANTIZE_KERNELS, self.kernels)
        with trace.span("run.copy_out"):
            return self.out[:rows].clone()


def run_bucketed(packed: PackedProgram, x, *, device: torch.device,
                 buckets: Sequence[int], fns: dict,
                 return_logits: bool = False) -> torch.Tensor:
    """Execute ``packed`` on a batch (array or tensor) on ``device``: pad
    it up to its bucket, run, and slice the padding off again.

    On a CUDA device the run is a replay of the key's ``Executable`` in
    ``fns`` (``executable_key`` -> ``Executable``), captured at the key's
    first request into the pool the entries of ``fns`` share; on the CPU
    it is ``execute_packed`` itself, and ``fns`` stays empty.
    """
    with trace.span("run"):
        with trace.span("run.stage_in"):
            x = torch.as_tensor(x, dtype=torch.float32).to(device)
            b = x.shape[0]
            x = pad_batch(x, bucket_batch(b, buckets))
        trace.count("rows", b)
        trace.count("padded_rows", x.shape[0] - b)
        if x.device.type != "cuda":
            return execute_packed(packed, x, return_logits=return_logits)[:b]
        key = executable_key(x.shape, buckets, return_logits)
        fn = fns.get(key)
        if fn is None:
            pool = next(iter(fns.values())).pool if fns else None
            with trace.span("run.capture"):
                fn = fns[key] = Executable.capture(
                    packed, x, return_logits=return_logits, pool=pool)
        return fn(x, b)


@dataclasses.dataclass
class ProgramServer:
    """A compiled + packed network on its device, ready for batches."""

    program: CrossbarProgram
    params: dict
    packed: PackedProgram
    device: torch.device
    return_logits: bool = False
    buckets: tuple[int, ...] = BUCKETS
    _fns: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def __call__(self, x) -> torch.Tensor:
        return run_bucketed(self.packed, x, device=self.device,
                            buckets=self.buckets, fns=self._fns,
                            return_logits=self.return_logits)

    def warmup(self, batch: int = 1) -> None:
        """Pay the set-up of one batch bucket ahead of traffic: on a GPU
        build the kernels and capture that bucket's graph (the
        counterpart of JAX's trace + compile); on the CPU run the batch
        once.

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
    package, never to reuse a request batch after the call; on the card
    the port copies each request into its graph's static input, and on
    the CPU it runs eagerly, so there is no request buffer to donate and
    the promise changes nothing.  ``device`` defaults to ``"cuda"``
    (``resolve_device``).
    """
    del donate_input            # accepted for parity; see the docstring
    dev = resolve_device(device)
    if config is not None:
        chip = chip or config.chip()
        cfg = cfg or config.crossbar()
    with trace.span("compile"):
        with trace.span("compile.lower"):
            program = compile_network(net, chip=chip, cfg=cfg)
        with trace.span("compile.params"):
            if params is None:
                if not isinstance(net, str):
                    raise ValueError("params are required for non-registry "
                                     "networks (only the named paper CNNs "
                                     "have a default init)")
                from repro_torch.models.cnn import CNN_MODELS   # lazy
                params = CNN_MODELS[net].init(
                    torch.Generator().manual_seed(seed))
            params = params_to(params, dev)
        with trace.span("compile.pack"):
            packed = pack_program(program, params)
    return ProgramServer(program=program, params=params, packed=packed,
                         device=dev, return_logits=return_logits,
                         buckets=tuple(buckets or ()))
