"""The port's sequence path (vit_tiny, token-input attention) against JAX's.

Both sides compute on the same weights (``convert.params_from_jax``) and
the same seeded numpy inputs.  Each dynamic-operand (attention) stage,
fed the reference's own input buffers, must mount the same int8 planes
(in the kernel layout), form the same per-slice requant factor and
produce the same int32 GEMM output; the context (P·V) stage's f32
output is then bit-exact, the probabilities (softmax FB) within a
relative 2e-6 (XLA's exp and row-sum order; the scaled logits before
the softmax are bit-exact).
Whole networks agree on the argmax and within a stated relative error,
and crossbar attention tracks the port's plain ``flash_attention``
within the bounds of ``tests/test_sequence.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.crossbar import quantize_scale as jax_quantize_scale
from repro.core.crossbar import quantize_symmetric as jax_quantize_symmetric
from repro.kernels.crossbar_gemm import crossbar_gemm as jax_crossbar_gemm
from repro.program.execute import _dyn_stage as jax_dyn_stage
from repro.program.execute import _static_stage as jax_static_stage
from repro.program.pack import plane_pack as jax_plane_pack
from repro.program.sequence import split_qkv_heads as jax_split_qkv_heads
from repro.program.sequence import tokens as jax_tokens
from repro_torch import api as tapi
from repro_torch.convert import params_from_jax
from repro_torch.core.crossbar import dequant_scale, quantize_scale
from repro_torch.kernels import (crossbar_gemm, flash_attention,
                                 kernel_layout, mount_weight)
from repro_torch.program.execute import _dyn_stage, dyn_mounts
from repro_torch.program.sequence import split_qkv_heads

from test_torch_cuda import WIDTHS

# a relative logit tolerance for whole networks: a softmax, GELU or
# layer norm output 1 ulp off XLA's can move one int8 value of the next
# stage's quantization by one step
SEQ_REL = 2e-2
# 4-bit operands on a 6-bit ADC: the dynamic stages mount K and V at
# weight_bits 4.  Held stage by stage: run free, the softmax's last-ulp
# differences (XLA's exp) decide exact ties of the next 4-bit
# quantization, and whole-network logits part by up to about a tenth
# (ROADMAP.md, section 3)
W4A4_ADC6 = WIDTHS["w4a4_adc6"]


def _vit_models(cfg_kw, seed=1, **graph_kw):
    jgraph = japi.vit_tiny_graph(**graph_kw)
    tgraph = tapi.vit_tiny_graph(**graph_kw)
    params = jax.tree.map(np.asarray, jgraph.init_params(
        jax.random.PRNGKey(seed)))
    jm = japi.compile(jgraph, japi.HurryConfig(**cfg_kw),
                      params=jax.tree.map(jnp.asarray, params))
    tm = tapi.compile(tgraph, tapi.HurryConfig(**cfg_kw),
                      params=params_from_jax(params), device="cpu")
    return jm, tm


def _x(graph, batch, seed=0):
    return np.random.default_rng(seed).standard_normal(
        graph.input_shape(batch)).astype(np.float32)


def _jax_mounts(gemm, cfg, bufs):
    """The JAX executor's per-slice mounts, requant factor and GEMM,
    vmapped and jitted: ``_dyn_stage``'s body up to the epilogue, from
    the JAX package's own functions."""
    @jax.jit
    def run(bufs):
        if gemm.dyn == "qk":
            q, k, _ = jax_split_qkv_heads(jax_tokens(bufs[gemm.src]),
                                          gemm.heads)
            a, w = q, jnp.swapaxes(k, 1, 2)
        else:
            a = bufs[gemm.src]
            _, _, w = jax_split_qkv_heads(jax_tokens(bufs[gemm.dyn_src]),
                                          gemm.heads)
        rows = min(gemm.tile_rows, a.shape[-1])

        def one(a2, w2):
            aq, ascale = jax_quantize_symmetric(a2, cfg.input_bits)
            w8, wamax = jax_plane_pack(w2, tile_rows=rows,
                                       weight_bits=cfg.weight_bits)
            a8 = aq.astype(jnp.int8)
            kp = w8.shape[0] - a8.shape[1]
            if kp:
                a8 = jnp.pad(a8, ((0, 0), (0, kp)))
            y = jax_crossbar_gemm(a8, w8, adc_bits=cfg.adc_bits, rows=rows,
                                  block_m=512, block_n=512, interpret=True)
            scale = (ascale * jax_quantize_scale(wamax, cfg.weight_bits)
                     ).astype(jnp.float32).reshape(1, 1)
            return a8, w8, scale, y

        return jax.vmap(one)(a, w)

    return run(bufs)


# ---------------------------------------------------------------------------
# dynamic stages, teacher-forced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph_kw,cfg_kw", [
    (dict(depth=1, dim=48, heads=3), dict()),
    (dict(depth=1, dim=48, heads=3), dict(adc_bits=5)),   # sliced branch
    (dict(), dict()),                                      # full width
    (dict(), W4A4_ADC6),                                   # 4-bit mounts
], ids=["small", "small-adc5", "full-width", "full-width-w4a4-adc6"])
def test_dyn_stages_bit_exact_with_teacher_forcing(graph_kw, cfg_kw):
    """Every stage of a vit_tiny forward is fed the reference's own
    buffers; at each dynamic stage the port's mounts (both in the kernel
    layout: ``kernel_layout`` of JAX's padded left operand and of its
    planes), per-slice requant factor and int32 GEMM output (``wt``
    alone, no (K, N) weight) must equal the JAX executor's, the context
    output bit for bit and the probabilities within a relative 2e-6
    (XLA's exp and row sum: a few ulps)."""
    jm, tm = _vit_models(cfg_kw, **graph_kw)
    jprog, cfg = jm.packed.program, jm.packed.program.cfg
    bufs = {"input": jnp.asarray(_x(jm.graph, 2))}
    seen = set()
    for (gemm, posts), jst in zip(jprog.stages(), jm.packed.stages):
        dst = posts[-1].dst if posts else gemm.dst
        tbufs = {k: torch.from_numpy(np.array(v)) for k, v in bufs.items()}
        if gemm.kind == "dyn_gemm":
            run = jax.jit(lambda b, g=gemm, p=posts: jax_dyn_stage(
                g, p, b, cfg, block_m=512, block_n=512, interpret=True))
            ref = np.asarray(run(bufs))
            ja8, jw8, jscale, jy = (np.array(t) for t in _jax_mounts(
                gemm, cfg, bufs))
            a8, wt, scale, rows, K = dyn_mounts(gemm, tbufs, tm.program.cfg)
            # both operands come in the kernel layout of K_pad
            assert K == jw8.shape[1] == ja8.shape[-1]
            np.testing.assert_array_equal(a8.numpy(), kernel_layout(
                torch.from_numpy(ja8), K, rows=rows,
                adc_bits=cfg.adc_bits).numpy())
            np.testing.assert_array_equal(wt.numpy(), mount_weight(
                torch.from_numpy(jw8), rows=rows,
                adc_bits=cfg.adc_bits).numpy())
            assert wt.is_contiguous()            # mounted K-major
            np.testing.assert_array_equal(scale.numpy(), jscale)
            y = crossbar_gemm(a8, adc_bits=cfg.adc_bits, rows=rows, wt=wt,
                              K=K)
            np.testing.assert_array_equal(y.numpy(), jy)
            got = _dyn_stage(gemm, posts, tbufs, tm.program.cfg).numpy()
            assert got.shape == ref.shape
            if gemm.dyn == "pv":
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-12)
            seen.add(gemm.dyn)
        else:
            run = jax.jit(lambda st, b, g=gemm, p=posts: jax_static_stage(
                g, p, st, b, cfg, block_m=512, block_n=512, interpret=True,
                drop_softmax=False)[1])
            ref = run(jst, bufs)
        bufs[dst] = jnp.asarray(ref)
    assert seen == {"qk", "pv"}


@pytest.mark.parametrize("graph_kw,cfg_kw", [
    (dict(depth=1, dim=48, heads=3), dict(adc_bits=5)),   # sliced branch
    (dict(depth=1), W4A4_ADC6),                            # 4-bit mounts
], ids=["small-adc5", "full-width-w4a4-adc6"])
def test_dyn_stage_dispatches_only_views_outside_the_kernels(
        graph_kw, cfg_kw, monkeypatch):
    """A dynamic stage is four kernel calls and nothing else: under a
    ``TorchDispatchMode`` every aten op that ``_dyn_stage`` dispatches
    outside ``quantize_layout`` (two calls: the right operand, then the
    left one with the requant factor), ``crossbar_gemm`` and
    ``fb_epilogue`` (one call each) is a view: no copy of the K or V
    heads, no scale product, no bias, no head merge, no pad.  The stage's
    output is the same with the mode on."""
    import importlib
    from torch.utils._python_dispatch import TorchDispatchMode
    execute = importlib.import_module("repro_torch.program.execute")
    model = tapi.compile(tapi.vit_tiny_graph(**graph_kw),
                         tapi.HurryConfig(**cfg_kw), seed=0, device="cpu")
    seen = []
    real_stage = execute._dyn_stage

    def record(gemm, posts, bufs, cfg, **kw):
        out = real_stage(gemm, posts, bufs, cfg, **kw)
        seen.append((gemm, posts, dict(bufs), cfg, kw, out))
        return out

    monkeypatch.setattr(execute, "_dyn_stage", record)
    execute.execute_packed(model.packed, torch.from_numpy(
        _x(model.graph, 2)), return_logits=True)
    monkeypatch.setattr(execute, "_dyn_stage", real_stage)
    assert {g.dyn for g, *_ in seen} == {"qk", "pv"}

    class Outside(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.inside = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.inside:
                self.ops.append(func)
            return func(*args, **(kwargs or {}))

    mode = Outside()
    calls: dict = {}

    def kernel(fn):
        def call(*args, **kw):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            mode.inside += 1
            try:
                return fn(*args, **kw)
            finally:
                mode.inside -= 1
        return call

    for name in ("quantize_layout", "crossbar_gemm", "fb_epilogue"):
        monkeypatch.setattr(execute, name, kernel(getattr(execute, name)))
    for gemm, posts, bufs, cfg, kw, want in seen:
        calls.clear()
        mode.ops.clear()
        with mode:
            got = execute._dyn_stage(gemm, posts, bufs, cfg, **kw)
        assert calls == dict(quantize_layout=2, crossbar_gemm=1,
                             fb_epilogue=1), (gemm.name, calls)
        assert mode.ops and all(op.is_view for op in mode.ops), (
            gemm.name, [op for op in mode.ops if not op.is_view])
        assert torch.equal(got, want)
        if gemm.dyn == "pv":                     # the heads merged on store
            qkv = bufs[gemm.dyn_src]
            assert got.shape == (*qkv.shape[:2], qkv.shape[-1] // 3)


def test_dyn_scale_is_the_plain_product_under_vmap():
    """Jitted and vmapped, ``ascale * ws`` stays a product of the two
    quantize scales: the port's scale equals it on every slice, and the
    reassociated ``dequant_scale`` form (what XLA makes of the static
    stages' scalar product) differs on some."""
    rng = np.random.default_rng(3)
    mag = rng.uniform(0.01, 10, (400, 1, 1)).astype(np.float32)
    a = rng.standard_normal((400, 8, 16)).astype(np.float32) * mag
    w = rng.standard_normal((400, 16, 8)).astype(np.float32) * mag[::-1]

    @jax.jit
    def jax_scale(a, w):
        def one(a2, w2):
            _, ascale = jax_quantize_symmetric(a2, 8)
            _, wamax = jax_plane_pack(w2, tile_rows=16, weight_bits=8)
            return (ascale * jax_quantize_scale(wamax, 8)).astype(
                jnp.float32)
        return jax.vmap(one)(a, w)

    ref = np.asarray(jax_scale(a, w))
    ta = torch.from_numpy(a).abs().amax(dim=(1, 2))
    tw = torch.from_numpy(w).abs().amax(dim=(1, 2))
    np.testing.assert_array_equal(
        (quantize_scale(ta) * quantize_scale(tw)).numpy(), ref)
    assert (dequant_scale(ta, tw).numpy() != ref).any()


# ---------------------------------------------------------------------------
# whole networks
# ---------------------------------------------------------------------------

def test_vit_tiny_end_to_end_against_jax():
    """Full width (dim 192, 3 heads, depth 2, 64 tokens), batch 3."""
    jm, tm = _vit_models(dict())
    x = _x(jm.graph, 3)
    ref = np.asarray(jm.run(jnp.asarray(x), logits=True))
    got = tm.run(x, logits=True).numpy()
    assert got.shape == ref.shape == (3, 10)
    assert (got.argmax(1) == ref.argmax(1)).all()
    assert np.abs(got - ref).max() <= SEQ_REL * np.abs(ref).max()
    probs = tm.run(x).numpy()
    jprobs = np.asarray(jm.run(jnp.asarray(x)))
    assert (probs.argmax(1) == jprobs.argmax(1)).all()
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-6)


def _attn_graph(mod, dim=64, heads=4):
    nb = mod.NetworkBuilder("attn_net", input_seq_dim=dim)
    nb.attention(heads, name="attn")
    return nb.build()


@pytest.mark.parametrize("seq", [8, 24])
def test_token_input_attention_against_jax(seq):
    """A token-input net (runtime sequence length) under the clip-free
    config, against the JAX package's compiled model."""
    jgraph, tgraph = _attn_graph(japi), _attn_graph(tapi)
    params = jax.tree.map(np.asarray, jgraph.init_params(
        jax.random.PRNGKey(seq)))
    cfg = dict(array_rows=511)
    jm = japi.compile(jgraph, japi.HurryConfig(**cfg), buckets=(),
                      params=jax.tree.map(jnp.asarray, params))
    tm = tapi.compile(tgraph, tapi.HurryConfig(**cfg), buckets=(),
                      params=params_from_jax(params), device="cpu")
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, 64)).astype(np.float32)
    ref = np.asarray(jm.run(jnp.asarray(x)))
    got = tm.run(x).numpy()
    assert got.shape == ref.shape == (2, seq, 64)
    assert np.abs(got - ref).max() <= SEQ_REL * np.abs(ref).max()


@pytest.mark.parametrize("batch", [3, 5])
def test_vit_odd_batches_equal_the_unbucketed_run(batch):
    """Edge replication keeps every per-tensor and per-(batch, head)
    quantization max, so the kept rows are bit-identical."""
    graph = tapi.vit_tiny_graph(depth=1, dim=48, heads=3)
    bucketed = tapi.compile(graph, seed=4, device="cpu")
    exact = tapi.compile(graph, seed=4, buckets=(), device="cpu")
    x = _x(graph, batch, seed=batch)
    got = bucketed.run(x, logits=True)
    assert got.shape == (batch, 10)
    assert torch.equal(got, exact.run(x, logits=True))


def test_token_input_warmup_and_run():
    model = tapi.compile(_attn_graph(tapi), device="cpu")
    model.warmup(batch=3, seq_len=12)
    out = model.run(np.zeros((3, 12, 64), np.float32))
    assert out.shape == (3, 12, 64) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# crossbar attention against the port's flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [16, 64])
def test_crossbar_attention_tracks_flash_attention(seq):
    """Mounting activations as int8 planes quantizes q/k/probs/v, so the
    crossbar attention output tracks float attention on the same
    projected q/k/v (non-causal) within the bounds of
    ``tests/test_sequence.py``: relative error < 0.12, correlation
    > 0.99."""
    dim, heads = 64, 4
    model = tapi.compile(_attn_graph(tapi, dim, heads),
                         tapi.HurryConfig(array_rows=511), buckets=(),
                         seed=seq, device="cpu")
    x = torch.from_numpy(np.random.default_rng(seq).standard_normal(
        (2, seq, dim)).astype(np.float32))
    y_cb = model.run(x).numpy()

    p = model.params["attn"]
    qkv = (x.reshape(-1, dim) @ p["wqkv"] + p["bqkv"]).reshape(2, seq, -1)
    q, k, v = (u.reshape(2, heads, seq, dim // heads).transpose(1, 2)
               for u in split_qkv_heads(qkv, heads))
    ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=False)
    y_fl = (ctx.reshape(2, seq, dim) @ p["wo"] + p["bo"]).numpy()
    rel = np.linalg.norm(y_cb - y_fl) / np.linalg.norm(y_fl)
    assert rel < 0.12, rel
    corr = np.corrcoef(y_cb.ravel(), y_fl.ravel())[0, 1]
    assert corr > 0.99, corr
