"""The front door's one executable per key, on the CPU.

On a CUDA device ``CompiledModel.run`` and ``ProgramServer`` capture
``execute_packed`` once per (bucket, flavor, input shape) as a CUDA
graph and replay it (``program.serve.Executable``).  What can be held
here: ``im2col``, now one gather for the whole batch, against the JAX
package's bit for bit; the executor makes no host sync and no tensor
whose shape depends on data (a dispatch mode over a run on the ``meta``
device, where a value read or a copy to or from the host shows as
such); the cache key; a replay's bookkeeping (counters, a fresh output)
over a stand-in graph; and that the CPU path stays eager with an empty
cache.  The capture itself runs on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 27).
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

from repro.program.execute import im2col as jax_im2col
from repro_torch import api, trace
from repro_torch.program.execute import X_LOAD_BYTES, execute_packed, im2col
from repro_torch.program.pack import PackedProgram
from repro_torch.program.serve import (BUCKETS, Executable, executable_key,
                                       make_server)

from test_torch_cuda import _token_graph
from torch_capture import CaptureSafety

_build = importlib.import_module("repro_torch.kernels._build")
_gemm = importlib.import_module("repro_torch.kernels.crossbar_gemm")
_fb = importlib.import_module("repro_torch.kernels.fb_epilogue")


# ---------------------------------------------------------------------------
# im2col: one gather, bit for bit the JAX package's
# ---------------------------------------------------------------------------

# (k, stride, pad): the zoo's 3x3 and 1x1 convs at strides 1 and 2,
# vit_tiny's 4x4 patch (k = stride, no pad), and AlexNet-like 5/1/2 and
# 11/4/2
IM2COL_CASES = [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0), (4, 4, 0),
                (5, 1, 2), (11, 4, 2)]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("k,stride,pad", IM2COL_CASES)
def test_im2col_equals_jax_bit_for_bit(k, stride, pad, batch):
    x = np.random.default_rng(k * 100 + stride * 10 + batch).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)
    got = im2col(torch.from_numpy(x), k, stride, pad)
    ref = np.asarray(jax_im2col(x, k, stride, pad))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# capture safety: no host sync, no data-dependent shape
# ---------------------------------------------------------------------------

@pytest.fixture
def safety(monkeypatch):
    mode = CaptureSafety()

    def paused(fn):
        def run(*args, **kw):
            mode.paused = True
            try:
                return fn(*args, **kw)
            finally:
                mode.paused = False
        return run

    for mod, name in ((_gemm, "crossbar_gemm_exact_ref"),
                      (_gemm, "crossbar_gemm_ref"), (_fb, "fb_epilogue_ref")):
        monkeypatch.setattr(mod, name, paused(getattr(mod, name)))
    return mode


def _on_meta(packed: PackedProgram) -> PackedProgram:
    def mv(t):
        return None if t is None else t.to("meta")
    return PackedProgram(
        stages=tuple(dataclasses.replace(st, **{
            f.name: mv(getattr(st, f.name)) for f in dataclasses.fields(st)})
            for st in packed.stages),
        program=packed.program)


CAPTURE_CASES = {
    "resnet18": ("resnet18", {}, 16),
    "alexnet-adc8": ("alexnet", dict(adc_bits=8), 16),
    "vit_tiny": ("vit_tiny", {}, 16),
    "tokens-T16": (None, {}, 16),
    "tokens-T32": (None, {}, 32),
}


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_execute_packed_is_capture_safe(case, logits, safety):
    """``execute_packed`` on ``meta`` tensors under ``CaptureSafety``:
    every op it dispatches (the kernels' plain versions aside) can be
    captured, and the output has the CPU run's shape."""
    net, cfg_kw, seq = CAPTURE_CASES[case]
    model = api.compile(net or _token_graph(), api.HurryConfig(**cfg_kw),
                        seed=3, device="cpu")
    packed = _on_meta(model.packed)
    x = torch.zeros(model.program.input_shape(3, seq_len=seq), device="meta")
    with safety:
        out = execute_packed(packed, x, return_logits=logits)
    assert safety.ops > 0 and out.device.type == "meta"
    assert out.shape == (3, 10)
    if case == "alexnet-adc8":     # the sliced branch is the one taken
        from repro_torch.kernels import clip_possible
        assert any(clip_possible(min(g.tile_rows, st.w8.shape[0]), 8)
                   for (g, _), st in zip(model.program.stages(),
                                         model.packed.stages))


@pytest.mark.parametrize("bad", ["item", "nonzero", "masked_select",
                                 "unique", "to_cpu", "from_cpu"])
def test_capture_safety_mode_rejects_what_cannot_be_captured(bad):
    """The mode above fails on each kind of op it is meant to catch."""
    ops = {
        "item": lambda t: t.sum().item(),
        "nonzero": lambda t: t.nonzero(),
        "masked_select": lambda t: t.masked_select(t > 0),
        "unique": lambda t: torch.unique(t),
        "to_cpu": lambda t: t.cpu(),
        "from_cpu": lambda t: t + torch.ones(4),
    }
    with pytest.raises(AssertionError), CaptureSafety():
        ops[bad](torch.zeros(4, device="meta"))


# ---------------------------------------------------------------------------
# the key, a replay's bookkeeping, the CPU path
# ---------------------------------------------------------------------------

def test_executable_key_is_bucket_flavor_and_shape():
    keys = {b: executable_key((b, 32, 32, 3), BUCKETS, False)
            for b in (1, 3, 4)}
    assert [k[0] for k in keys.values()] == [1, 4, 4]
    assert keys[3] == keys[4] != keys[1]
    assert executable_key((3, 32, 32, 3), BUCKETS, True) != keys[3]
    t16 = executable_key((2, 16, 32), BUCKETS, False)
    t32 = executable_key((2, 32, 32), BUCKETS, False)
    assert t16 != t32 and t16[:2] == t32[:2] == (2, False)
    # beyond the ladder, or without one, the batch is its own bucket
    assert executable_key((300, 8), BUCKETS, False)[0] == 300
    assert executable_key((3, 8), (), False)[0] == 3


class _DoublingGraph:
    """Stands in for a captured graph: a replay writes 2 * x to out."""

    def __init__(self, x, out):
        self.x, self.out, self.replays = x, out, 0

    def replay(self):
        self.out.copy_(2 * self.x)
        self.replays += 1


def test_counted_holds_the_six_wrappers():
    """Each of the six kernel wrappers, one a ``csrc`` source, counts its
    launches in ``repro_torch.trace`` as ``launches.<wrapper>``, at one
    line, and keeps no count of its own."""
    assert _build.SOURCES == ("crossbar_gemm", "fb_epilogue",
                              "flash_attention", "fused_gemm_epilogue",
                              "packed_gemm", "quantize_layout")
    for name in _build.SOURCES:
        module = importlib.import_module(f"repro_torch.kernels.{name}")
        src = inspect.getsource(module)
        assert src.count(f'trace.count("launches.{name}")') == 1, name
        assert not hasattr(getattr(module, name), "launches"), name


def test_replay_adds_the_captured_launches_and_returns_a_new_tensor():
    """Each replay adds all its recording counted (launches and bytes)."""
    x, out = torch.zeros(4, 3), torch.zeros(4, 3)
    graph = _DoublingGraph(x, out)
    counts = {"launches.crossbar_gemm": 5, "launches.fb_epilogue": 5,
              "launches.quantize_layout": 5, X_LOAD_BYTES: 12288}
    exe = Executable(graph=graph, x=x, out=out, pool=(0, 0),
                     counts=counts, capture_s=0.0)
    before = trace.counters()
    a = exe(torch.arange(12.0).reshape(4, 3), 3)
    b = exe(torch.ones(4, 3), 4)
    assert graph.replays == 2
    after = trace.counters()
    assert {k: after[k] - before.get(k, 0) for k in counts} == {
        k: 2 * n for k, n in counts.items()}
    # each answer is its own tensor: the next replay does not move it
    assert torch.equal(a, 2 * torch.arange(9.0).reshape(3, 3))
    assert torch.equal(b, torch.full((4, 3), 2.0))
    assert a.data_ptr() != out.data_ptr() != b.data_ptr()


def test_cpu_run_is_eager_and_caches_nothing(tmp_path):
    model = api.compile(_token_graph(), seed=4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 16, 32)).astype(np.float32))
    before = trace.counters()
    got = model.run(x, logits=True)
    model.warmup(batch=3, seq_len=16)
    assert torch.equal(got, execute_packed(
        model.packed, torch.cat([x, x[-1:]]), return_logits=True)[:3])
    assert model._fns == {}
    after = trace.counters()
    assert [after.get(k, 0) - before.get(k, 0) for k in (
        "launches.crossbar_gemm", "launches.fb_epilogue")] == [0, 0]
    assert "_fns" not in repr(model)
    field = {f.name: f for f in dataclasses.fields(model)}["_fns"]
    assert not field.compare and not field.repr
    loaded = api.load(model.save(str(tmp_path / "tok.npz")), device="cpu")
    assert loaded._fns == {}
    assert torch.equal(loaded.run(x, logits=True), got)
    server = make_server(model.graph, model.params, config=model.config,
                         return_logits=True, device="cpu")
    server.warmup(batch=3)
    assert torch.equal(server(x), got) and server._fns == {}
