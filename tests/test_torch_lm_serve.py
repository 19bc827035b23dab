"""The port's serving stack (``repro_torch.serve``, ``launch.serve``) on
the CPU: the int8 KV cache against eager JAX, the serving steps against
the port's own model functions, and the launcher in a subprocess."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serve import kv_quant as jkv
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve.kv_quant import (dequantize_kv, init_quant_kv_cache,
                                        quantize_kv, read_quant_cache,
                                        update_quant_cache)
from repro_torch.serve.step import (greedy_generate, make_decode_step,
                                    make_prefill_step)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:  # pragma: no cover
    HAVE_HYP = False

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _x(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [3.0, 1e-3, 200.0])
def test_quantize_kv_equals_eager_jax(scale):
    """int8 values and scales bit for bit, including all-zero rows (the
    1e-8 amax floor)."""
    x = _x(0, (2, 16, 4, 64), scale)
    x[0, 3] = 0.0
    q_ref, s_ref = jkv.quantize_kv(jnp.asarray(x))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(q_ref))
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        rt = dequantize_kv(q, s, dtype).float().numpy()
        ref = np.asarray(jkv.dequantize_kv(q_ref, s_ref, jdtype), np.float32)
        assert np.array_equal(rt, ref)


@pytest.mark.parametrize("window", [0, 5])
def test_quant_cache_updates_equal_eager_jax(window):
    """Twelve one-token appends (a 5-slot ring buffer wraps twice) and one
    three-token append: every field equal to JAX's."""
    jcfg = dataclasses.replace(jax_get_config("qwen3_8b").reduced(),
                               sliding_window=window)
    cfg = dataclasses.replace(get_config("qwen3_8b").reduced(),
                              sliding_window=window)
    jc = jkv.init_quant_kv_cache(2, 16, jcfg)
    tc = init_quant_kv_cache(2, 16, cfg, device="cpu")
    for i, s in enumerate([1] * 12 + [3]):
        k = _x(2 * i + 1, (2, s, cfg.n_kv_heads, cfg.resolved_head_dim))
        v = _x(2 * i + 2, (2, s, cfg.n_kv_heads, cfg.resolved_head_dim))
        jc = jkv.update_quant_cache(jc, jnp.asarray(k), jnp.asarray(v))
        tc = update_quant_cache(tc, torch.from_numpy(k), torch.from_numpy(v))
        for key in jc:
            assert np.array_equal(tc[key].numpy(), np.asarray(jc[key])), key
    kr, vr = jkv.read_quant_cache(jc, jnp.float32)
    k, v = read_quant_cache(tc, torch.float32)
    assert np.array_equal(k.numpy(), np.asarray(kr))
    assert np.array_equal(v.numpy(), np.asarray(vr))


def test_roundtrip_error_bound():
    x = torch.from_numpy(_x(3, (2, 16, 4, 64)))
    q, s = quantize_kv(x)
    err = (dequantize_kv(q, s, torch.float32) - x).abs()
    assert (err <= s[..., None] * 0.5 + 1e-6).all()


def test_attention_with_quant_cache_matches_fp():
    """Decode attention over an int8 cache ~= over the float cache."""
    cfg = get_config("qwen3_8b").reduced()
    b, steps = 2, 12
    hkv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    gen = torch.Generator().manual_seed(1)
    qc = init_quant_kv_cache(b, steps, cfg, device="cpu")
    k_hist, v_hist = [], []
    for _ in range(steps):
        k = torch.randn((b, 1, hkv, hd), generator=gen)
        v = torch.randn((b, 1, hkv, hd), generator=gen)
        qc = update_quant_cache(qc, k, v)
        k_hist.append(k)
        v_hist.append(v)
    kq, vq = read_quant_cache(qc, torch.float32)
    k_fp, v_fp = torch.cat(k_hist, 1), torch.cat(v_hist, 1)
    q = torch.randn((b, 1, h, hd), generator=gen)
    valid = torch.ones(steps, dtype=torch.bool)
    out_q = L._decode_mha(q, kq, vq, valid, hd, h, hkv)
    out_fp = L._decode_mha(q, k_fp, v_fp, valid, hd, h, hkv)
    torch.testing.assert_close(out_q, out_fp, rtol=0.05, atol=0.05)
    # int8 halves cache bytes vs bf16 (scales are per-head, amortized)
    bf16_bytes = k_fp.numel() * 2 * 2
    q_bytes = qc["k"].numel() * 2 + qc["k_scale"].numel() * 4 * 2
    assert q_bytes < 0.7 * bf16_bytes


if HAVE_HYP:
    @given(st.integers(0, 2**16), st.floats(0.1, 100.0))
    @settings(max_examples=20, deadline=None)
    def test_property_quant_bound(seed, scale):
        x = torch.from_numpy(_x(seed, (4, 8), scale))
        q, s = quantize_kv(x)
        err = (dequantize_kv(q, s, torch.float32) - x).abs()
        assert (err <= s[..., None] * 0.5 + 1e-5).all()


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def _model(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    return cfg, params


@pytest.mark.parametrize("arch", ["qwen3_8b", "zamba2_2_7b", "xlstm_1_3b",
                                  "whisper_medium"])
def test_greedy_generate_equals_a_loop_of_decode_steps(arch):
    cfg, params = _model(arch)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen,
                           dtype=torch.int32)
    states = None
    if cfg.is_encdec:
        frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
        states = lm.encode(params, cfg, frames)
    out = greedy_generate(cfg, params, prompt, 4, encoder_states=states)
    assert out.shape == (2, 9) and torch.equal(out[:, :5], prompt)

    step = make_decode_step(cfg)
    caches = lm.init_caches(cfg, 2, 9, params=params)
    tok, want = prompt[:, :1], [prompt[:, :1]]
    for i in range(8):
        nxt, logits, caches = step(params, tok, caches, i,
                                   encoder_states=states)
        assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).int())
        tok = prompt[:, i + 1:i + 2] if i + 1 < 5 else nxt
        want.append(tok)
    assert torch.equal(out, torch.cat(want, 1))


@pytest.mark.parametrize("arch", ["qwen2_vl_72b", "whisper_medium"])
def test_prefill_step_is_the_last_position_of_forward(arch):
    cfg, params = _model(arch, seed=1)
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 7), generator=gen)
    frames = (torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
              if cfg.is_encdec else None)
    got = make_prefill_step(cfg)(params, tokens, frames)
    full = lm.forward(params, cfg, tokens, encoder_input=frames)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, full[:, -1])


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_launcher_serves_on_the_cpu():
    proc = _launch("--arch", "mixtral_8x22b", "--device",
                   "cpu", "--batch", "2", "--rounds", "2", "--new-tokens",
                   "3")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[:2] == ["round 0: 2 seqs x 3 tokens",
                         "round 1: 2 seqs x 3 tokens"]
    assert lines[2].startswith("served 12 tokens in ") and \
        lines[2].endswith("mixtral_8x22b reduced, CPU)")


def test_launcher_without_a_device_raises_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    proc = _launch("--arch", "whisper_medium", "--rounds", "1")
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
