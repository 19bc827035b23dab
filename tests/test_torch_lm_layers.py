"""The port's LM layers (``repro_torch.models.layers``) against their JAX
twins in ``repro.models.layers``, function by function, on the CPU.

Inputs are numpy draws from a seed; parameters come from the JAX init
functions and cross with ``convert.tree_from_jax``.  Compute is float32.
Tolerances are relative to the reference's max |value|: 1e-5 where the
two sides differ only in the order of a matmul's or a reduction's sums
(measured gaps are ~1e-7 to 1e-6), 1e-4 for the chunked scans, whose
``exp`` of cumulative sums and three-operand einsums compound those
orders (measured below 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import layers as L

TOL = 1e-5
SCAN_TOL = 1e-4


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(tree):
    """JAX params as numpy (for JAX) and as tensors (for the port)."""
    np_tree = jax.tree.map(np.array, tree)
    return np_tree, tree_from_jax(np_tree, device="cpu")


def _cfgs(arch, **over):
    """The reduced config in both packages, with the same replacements."""
    return (dataclasses.replace(jax_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = _randn(rng, 3, 5, 64, scale=3.0) + 1.5
    p = {"scale": _randn(rng, 64), "bias": _randn(rng, 64)}
    if kind == "rmsnorm":
        del p["bias"]
    ref = JL.apply_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p), kind,
                        1e-5)
    got = L.apply_norm(_t(x), tree_from_jax(p), kind, 1e-5)
    assert _rel(got, ref) <= TOL
    init = L.init_norm(64, kind, device="cpu")
    assert jax.tree.map(np.asarray, JL.init_norm(64, kind)).keys() \
        == init.keys()


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert _rel(L.apply_rope(_t(x), _t(pos), theta), ref) <= TOL
    assert torch.equal(L.apply_rope(_t(x), _t(pos), 0.0), _t(x))


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_with_distinct_position_components(sections):
    """M-RoPE from (3, B, S) positions whose three components differ; the
    second case is Qwen2-VL's published sections at the reduced head_dim
    of 16, where JAX's slicing leaves the height and width sections
    empty."""
    rng = np.random.default_rng(2)
    x = _randn(rng, 2, 6, 2, 16)
    pos = np.stack([rng.integers(0, 100, (2, 6)) for _ in range(3)]) \
        .astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_rope(_t(x), _t(pos), 1e6, sections)
    assert _rel(got, ref) <= TOL
    # equal components degenerate to plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape)
    assert torch.allclose(L.apply_rope(_t(x), _t(same), 1e6, (2, 3, 3)),
                          L.apply_rope(_t(x), _t(pos[0]), 1e6), atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, sk, h, hd):
    return (_randn(rng, b, sq, h, hd), _randn(rng, b, sk, h, hd),
            _randn(rng, b, sk, h, hd))


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 5, 0), (False, 5, 0), (True, 0, 7),
    (True, 3, 7)])
def test_mha_matches_jax(causal, window, q_offset):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 12, 12 + q_offset, 3, 16)
    ref = JL.mha(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                 q_offset=q_offset)
    got = L.mha(_t(q), _t(k), _t(v), causal=causal, window=window,
                q_offset=q_offset)
    assert _rel(got, ref) <= TOL


def test_mha_fully_masked_rows_are_zero():
    """Causal with a negative q_offset: the first rows see no key.  The
    Eq. 1 clamps make them zeros (SDPA would give NaN)."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, 6, 6, 2, 16)
    ref = np.asarray(JL.mha(*map(jnp.asarray, (q, k, v)), causal=True,
                            q_offset=-2))
    got = L.mha(_t(q), _t(k), _t(v), causal=True, q_offset=-2)
    assert torch.isfinite(got).all()
    assert (got[:, :2] == 0).all() and (ref[:, :2] == 0).all()
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("sq,sk,causal,window", [
    (30, 30, True, 4),      # banded: window + chunk < sk, start clipped
    (32, 32, False, 4),     # banded, not causal
    (30, 30, True, 0),      # full scores per chunk
    (30, 30, True, 25),     # window + chunk >= sk: not banded
    (13, 40, False, 0)])    # cross-attention shape, sq != sk
def test_mha_chunked_matches_jax(sq, sk, causal, window):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, sq, sk, 2, 16)
    ref = JL.mha_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                         window=window, chunk=8)
    got = L.mha_chunked(_t(q), _t(k), _t(v), causal=causal, window=window,
                        chunk=8)
    assert got.shape == (2, sq, 2, 16)
    assert _rel(got, ref) <= TOL
    # and the same as the unchunked attention, except where JAX's band is
    # wrong: banded and not causal, the band [ci*chunk - window, ci*chunk
    # + chunk) cuts off the later keys that ``mha``'s window keeps (no
    # model takes that branch: windowed attention is causal in all ten)
    full = L.mha(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    if sq == sk and (causal or not window):
        assert _rel(got, full) <= TOL
    elif sq == sk:
        assert _rel(got, full) > 0.1


@pytest.mark.parametrize("window,steps", [(0, 9), (4, 11)])
def test_attention_with_kv_cache_matches_jax(window, steps):
    """Qwen3's reduced attention (qk-norm, GQA 4/2) decoding one token at
    a time through its cache; with ``window`` 4 the cache is a 4-slot ring
    buffer decoded well past its window.  Every step's output and cache
    match JAX's, and the decoded outputs equal the full-sequence layer's
    (the ring holds exactly the window's keys)."""
    jcfg, cfg = _cfgs("qwen3_8b", sliding_window=window)
    rng = np.random.default_rng(6)
    jp, tp = _params(JL.init_attention(jax.random.PRNGKey(1), cfg.d_model,
                                       cfg.n_heads, cfg.n_kv_heads,
                                       cfg.resolved_head_dim, True))
    x = _randn(rng, 2, steps, cfg.d_model)
    jc = JL.init_kv_cache(2, steps, jcfg, jnp.float32)
    tc = L.init_kv_cache(2, steps, cfg, torch.float32, device="cpu")
    assert tc["k"].shape == jc["k"].shape == \
        (2, min(steps, window) if window else steps, 2, 16)
    outs = []
    for i in range(steps):
        pos = np.full((2, 1), i, np.int32)
        ref, jc = JL.attention(jp, jnp.asarray(x[:, i:i + 1]),
                               jnp.asarray(pos), jcfg, kv_cache=jc)
        got, tc = L.attention(tp, _t(x[:, i:i + 1]), _t(pos), cfg,
                              kv_cache=tc)
        assert _rel(got, ref) <= TOL
        for key in ("k", "v"):
            assert _rel(tc[key], jc[key]) <= TOL
        assert int(tc["index"]) == int(jc["index"]) == i + 1
        outs.append(got)
    pos = np.broadcast_to(np.arange(steps, dtype=np.int32), (2, steps))
    full, _ = L.attention(tp, _t(x), _t(np.ascontiguousarray(pos)), cfg)
    assert _rel(torch.cat(outs, 1), full.numpy()) <= TOL


def test_attention_prefills_a_cache_then_decodes():
    """Three tokens written into the cache at once (no causal mask among
    them, as in JAX), then one more."""
    jcfg, cfg = _cfgs("internlm2_1_8b")
    rng = np.random.default_rng(7)
    jp, tp = _params(JL.init_attention(jax.random.PRNGKey(2), cfg.d_model,
                                       cfg.n_heads, cfg.n_kv_heads,
                                       cfg.resolved_head_dim))
    x = _randn(rng, 1, 4, cfg.d_model)
    jc = JL.init_kv_cache(1, 6, jcfg, jnp.float32)
    tc = L.init_kv_cache(1, 6, cfg, torch.float32, device="cpu")
    for lo, hi in ((0, 3), (3, 4)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        ref, jc = JL.attention(jp, jnp.asarray(x[:, lo:hi]),
                               jnp.asarray(pos), jcfg, kv_cache=jc)
        got, tc = L.attention(tp, _t(x[:, lo:hi]), _t(pos), cfg,
                              kv_cache=tc)
        assert _rel(got, ref) <= TOL and _rel(tc["k"], jc["k"]) <= TOL


def test_cross_attention_matches_jax():
    jcfg, cfg = _cfgs("whisper_medium")
    rng = np.random.default_rng(8)
    jp, tp = _params(JL.init_attention(jax.random.PRNGKey(3), cfg.d_model,
                                       cfg.n_heads, cfg.n_kv_heads,
                                       cfg.resolved_head_dim))
    x = _randn(rng, 2, 5, cfg.d_model)
    kx, vx = (_randn(rng, 2, 9, cfg.n_kv_heads, cfg.resolved_head_dim)
              for _ in range(2))
    pos = np.zeros((2, 5), np.int32)
    ref, _ = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                          causal=False, cross_kv=(jnp.asarray(kx),
                                                  jnp.asarray(vx)))
    got, _ = L.attention(tp, _t(x), _t(pos), cfg, causal=False,
                         cross_kv=(_t(kx), _t(vx)))
    assert _rel(got, ref) <= TOL


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(9)
    jp, tp = _params(JL.init_mlp(jax.random.PRNGKey(4), 64, 128))
    x = _randn(rng, 2, 7, 64)
    ref = JL.mlp(jp, jnp.asarray(x), act)
    assert _rel(L.mlp(tp, _t(x), act), ref) <= TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_with_capacity_drops_matches_jax(act):
    """4 experts, top 2, 16 tokens a row: capacity int(1.25*16*2/4) = 10.
    Inputs lean towards expert 0 so that it is picked more than 10 times
    in every row and tokens are dropped."""
    E, k, s, d = 4, 2, 16, 64
    rng = np.random.default_rng(10)
    jp, tp = _params(JL.init_moe(jax.random.PRNGKey(5), d, 128, E))
    x = _randn(rng, 3, s, d) + 0.5
    jp["router"][:, 0] = 0.5
    tp["router"][:, 0] = 0.5
    picks = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ jp["router"], -1), k)[1])
    assert ((picks == 0).sum((1, 2)) > 10).all()         # drops fire
    ref = JL.moe(jp, jnp.asarray(x), E, k, act)
    got = L.moe(tp, _t(x), E, k, act)
    assert _rel(got, ref) <= TOL
    # a dropped (token, expert) pair contributes nothing: with capacity
    # for every pick the output moves
    roomy = L.moe(tp, _t(x), E, k, act, capacity_factor=4.0)
    assert not torch.allclose(roomy, got)


# ---------------------------------------------------------------------------
# Mamba2, mLSTM, sLSTM: the chunked / sequential forms and their steps
# ---------------------------------------------------------------------------

def _mamba_params(cfg, rng):
    jp, _ = _params(JL.init_mamba2(jax.random.PRNGKey(6), cfg.d_model, cfg))
    h = jp["A_log"].shape[0]
    # the init's zeros / ones would leave A, D and dt_bias untested
    jp["A_log"] = _randn(rng, h, scale=0.5)
    jp["D"] = _randn(rng, h)
    jp["dt_bias"] = _randn(rng, h, scale=0.5)
    return jp, tree_from_jax(jp)


@pytest.mark.parametrize("chunk", [128, 8])
def test_mamba2_matches_jax(chunk):
    jcfg, cfg = _cfgs("zamba2_2_7b")
    rng = np.random.default_rng(11)
    jp, tp = _mamba_params(cfg, rng)
    x = _randn(rng, 2, 21, cfg.d_model)
    ref = JL.mamba2(jp, jnp.asarray(x), jcfg, chunk=chunk)
    assert _rel(L.mamba2(tp, _t(x), cfg, chunk=chunk), ref) <= SCAN_TOL


def test_mamba2_step_matches_jax_and_the_chunked_form():
    jcfg, cfg = _cfgs("zamba2_2_7b")
    rng = np.random.default_rng(12)
    jp, tp = _mamba_params(cfg, rng)
    x = _randn(rng, 2, 10, cfg.d_model)
    js = JL.init_mamba2_state(2, jp, jcfg, cfg.d_model)
    ts = L.init_mamba2_state(2, tp, cfg, cfg.d_model, device="cpu")
    outs = []
    for i in range(10):
        ref, js = JL.mamba2_step(jp, jnp.asarray(x[:, i:i + 1]), js, jcfg)
        got, ts = L.mamba2_step(tp, _t(x[:, i:i + 1]), ts, cfg)
        assert _rel(got, ref) <= TOL
        assert _rel(ts["ssm"], js["ssm"]) <= TOL
        assert _rel(ts["conv"], js["conv"]) <= TOL
        outs.append(got)
    assert _rel(torch.cat(outs, 1), L.mamba2(tp, _t(x), cfg).numpy()) \
        <= SCAN_TOL


@pytest.mark.parametrize("chunk,s", [(512, 21), (8, 21), (8, 24)])
def test_mlstm_matches_jax(chunk, s):
    jcfg, cfg = _cfgs("xlstm_1_3b")
    rng = np.random.default_rng(13)
    jp, tp = _params(JL.init_mlstm(jax.random.PRNGKey(7), cfg.d_model, cfg))
    x = _randn(rng, 2, s, cfg.d_model)
    ref = JL.mlstm(jp, jnp.asarray(x), jcfg, chunk=chunk)
    assert _rel(L.mlstm(tp, _t(x), cfg, chunk=chunk), ref) <= SCAN_TOL


def test_mlstm_step_matches_jax():
    jcfg, cfg = _cfgs("xlstm_1_3b")
    rng = np.random.default_rng(14)
    jp, tp = _params(JL.init_mlstm(jax.random.PRNGKey(8), cfg.d_model, cfg))
    x = _randn(rng, 2, 8, cfg.d_model)
    js = JL.init_mlstm_state(2, cfg.d_model, jcfg)
    ts = L.init_mlstm_state(2, cfg.d_model, cfg, device="cpu")
    for i in range(8):
        ref, js = JL.mlstm_step(jp, jnp.asarray(x[:, i:i + 1]), js, jcfg)
        got, ts = L.mlstm_step(tp, _t(x[:, i:i + 1]), ts, cfg)
        assert _rel(got, ref) <= TOL
        for key in ("C", "n", "m"):
            assert _rel(ts[key], js[key]) <= TOL, key


def test_slstm_and_its_step_match_jax():
    jcfg, cfg = _cfgs("xlstm_1_3b")
    rng = np.random.default_rng(15)
    jp, tp = _params(JL.init_slstm(jax.random.PRNGKey(9), cfg.d_model, cfg))
    x = _randn(rng, 2, 9, cfg.d_model)
    ref = JL.slstm(jp, jnp.asarray(x), jcfg)
    full = L.slstm(tp, _t(x), cfg)
    assert _rel(full, ref) <= TOL
    js = JL.init_slstm_state(2, cfg.d_model)
    ts = L.init_slstm_state(2, cfg.d_model, device="cpu")
    outs = []
    for i in range(9):
        r, js = JL.slstm_step(jp, jnp.asarray(x[:, i:i + 1]), js, jcfg)
        got, ts = L.slstm_step(tp, _t(x[:, i:i + 1]), ts, cfg)
        assert _rel(got, r) <= TOL
        for key in ("c", "n", "m", "h"):
            assert _rel(ts[key], js[key]) <= TOL, key
        outs.append(got)
    assert _rel(torch.cat(outs, 1), full.numpy()) <= TOL


def test_layer_inits_match_jax_shapes():
    """Each layer init against JAX's: keys, shapes and dtypes, one layer
    and stacked on leading axes."""
    cfg = get_config("zamba2_2_7b").reduced()
    xcfg = get_config("xlstm_1_3b").reduced()
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    pairs = [
        (JL.init_attention(key, 64, 4, 2, 16, True),
         lambda st: L.init_attention(gen, 64, 4, 2, 16, True, device="cpu",
                                     stack=st)),
        (JL.init_mlp(key, 64, 128),
         lambda st: L.init_mlp(gen, 64, 128, device="cpu", stack=st)),
        (JL.init_moe(key, 64, 128, 4),
         lambda st: L.init_moe(gen, 64, 128, 4, device="cpu", stack=st)),
        (JL.init_mamba2(key, 64, cfg),
         lambda st: L.init_mamba2(gen, 64, cfg, device="cpu", stack=st)),
        (JL.init_mlstm(key, 64, xcfg),
         lambda st: L.init_mlstm(gen, 64, xcfg, device="cpu", stack=st)),
        (JL.init_slstm(key, 64, xcfg),
         lambda st: L.init_slstm(gen, 64, xcfg, device="cpu", stack=st)),
    ]
    for ref, init in pairs:
        for stack in ((), (3, 2)):
            got = init(stack)
            assert got.keys() == ref.keys()
            for name, r in ref.items():
                assert tuple(got[name].shape) == stack + r.shape, name
                assert got[name].dtype == torch.float32
