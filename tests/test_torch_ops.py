"""The port's ``kernels.ops`` and its new kernels' plain versions against
the JAX package's Pallas kernels (interpret mode) and ``repro.kernels.ref``.

On the CPU every wrapper computes its plain PyTorch version.  Inputs are
made with numpy from a seed and handed to both packages.  Float kernels
are held to the JAX tests' own tolerances (``tests/test_kernels.py``):
1e-4 in float32, 2e-2 in bfloat16, because the two sum their products
in different orders.  The host helpers of ``packed_gemm`` and the
batched crossbar launches must match exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import (crossbar_gemm, fb_epilogue, flash_attention,
                                 flash_attention_ref,
                                 flash_attention_split_ref,
                                 fused_gemm_epilogue, ops, packed_gemm,
                                 pad_groups, tile_group_map)

fa_module = importlib.import_module("repro_torch.kernels.flash_attention")
fused_module = importlib.import_module(
    "repro_torch.kernels.fused_gemm_epilogue")
packed_module = importlib.import_module("repro_torch.kernels.packed_gemm")


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 128, 1, 64), (2, 128, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(shape, causal):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (_normal(rng, shape) for _ in range(3))
    ref = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got, ref, 1e-4)
    _close(got, jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal),
           1e-4)


def test_flash_attention_sliding_window():
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (1, 256, 2, 32)) for _ in range(3))
    ref = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=64,
                               block_q=64, block_k=64, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=64,
                          block_q=64, block_k=64)
    _close(got, ref, 1e-4)


def test_flash_attention_bf16():
    rng = np.random.default_rng(9)
    q, k, v = (_normal(rng, (1, 128, 2, 64)) for _ in range(3))
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    ref = jops.flash_attention(*bf, causal=True, interpret=True)
    got = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                          causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref, np.float32), 2e-2)


def test_attention_expands_gqa_heads():
    rng = np.random.default_rng(11)
    q = _normal(rng, (1, 128, 8, 32))
    k, v = _normal(rng, (1, 128, 2, 32)), _normal(rng, (1, 128, 2, 32))
    got = ops.attention(_t(q), _t(k), _t(v), causal=True)
    ke, ve = np.repeat(k, 4, axis=2), np.repeat(v, 4, axis=2)
    _close(got, jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(ke),
                                         jnp.asarray(ve), causal=True), 1e-4)
    _close(got, jops.attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True), 1e-4)
    with pytest.raises(ValueError, match="multiple of 3 kv heads"):
        ops.attention(_t(q), _t(k[:, :, :1]).repeat(1, 1, 3, 1),
                      _t(v[:, :, :1]).repeat(1, 1, 3, 1))


def test_flash_attention_rejects_what_jax_rejects():
    z = torch.zeros(1, 192, 1, 64)
    with pytest.raises(ValueError, match="not multiples of the blocks"):
        flash_attention(z, z, z)              # 192 % 128
    flash_attention(z, z, z, block_q=64, block_k=64)
    big = torch.zeros(1, 16, 1, 160)
    with pytest.raises(ValueError, match="head dim 160"):
        flash_attention(big, big, big)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(z.half(), z.half(), z.half(), block_q=64, block_k=64)


def test_flash_attention_ref_masked_rows_are_zero():
    """A query that sees no key (window past the keys) gets 0, not NaN:
    the -1e30 floor on the max and the 1e-30 floor on the sum."""
    q = torch.ones(1, 4, 1, 8)
    k = v = torch.ones(1, 2, 1, 8)
    out = flash_attention_ref(q, k, v, causal=False, window=1)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0, 2:], torch.zeros(2, 1, 8))


# The key split (the CUDA kernel's shares of each query tile's keys and
# their merge) in its plain version, against the Pallas kernel.  The
# merge re-orders the sums over keys: measured at most 1.1e-6 absolute
# here, held to 2e-6 absolute + 1e-5 relative.
SPLIT_CASES = [
    ((1, 512, 2, 64), True, 0),          # causal: shares of the lower rows
    ((1, 512, 2, 64), False, 128),       # a 128-key window
    ((2, 96, 2, 64), False, 0),          # 64-key tiles: a ragged last one
    ((1, 80, 2, 128), True, 0),          # 32-key tiles (hd 128): ragged
]


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("shape,causal,window", SPLIT_CASES)
def test_flash_attention_split_plain_matches_pallas(shape, causal, window,
                                                   splits):
    rng = np.random.default_rng(sum(shape) + splits)
    q, k, v = (_normal(rng, shape) for _ in range(3))
    ref = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               interpret=True)
    got = flash_attention_split_ref(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, splits=splits)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 128), (False, 100)])
def test_flash_attention_key_split_rule(causal, window):
    """The split count is a function of the shape; every share is a
    non-empty, contiguous run of key tiles inside the keys its queries
    can see, and the shares of a query tile cover those keys in order."""
    for b, s, h, hd in [(1, 512, 4, 64), (16, 64, 3, 64), (1, 256, 4, 16),
                        (8, 512, 8, 64), (1, 80, 2, 128), (2, 96, 2, 64)]:
        sp = fa_module.key_splits(b, h, s, s, hd)
        assert sp == fa_module.key_splits(b, h, s, s, hd)
        assert 1 <= sp <= fa_module.MAX_SPLITS
        bq, bk = fa_module.query_tile(s), fa_module.key_tile(hd)
        if b * h * -(-s // bq) >= fa_module.SPLIT_BLOCKS:
            assert sp == 1
        for forced in (1, 2, 4, sp):
            shares = fa_module.key_ranges(s, s, hd, causal=causal,
                                          window=window, splits=forced)
            assert shares == fa_module.key_ranges(
                s, s, hd, causal=causal, window=window, splits=forced)
            assert len(shares) == -(-s // bq)
            for qi, tile in enumerate(shares):
                q0, q_last = qi * bq, min((qi + 1) * bq, s) - 1
                hi = q_last + 1 if causal else s
                lo = max(0, q0 - window + 1) if window else 0
                assert 1 <= len(tile) <= forced
                assert tile[0][0] == lo // bk * bk and tile[-1][1] == hi
                for (a, b_), (c, _) in zip(tile, tile[1:]):
                    assert b_ == c
                for a, b_ in tile:
                    assert a < b_ and a % bk == 0


# ---------------------------------------------------------------------------
# fused_gemm_epilogue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("with_res", [False, True])
def test_linear_fused_plain_matches_pallas(act, with_res):
    rng = np.random.default_rng(3)
    x, w = _normal(rng, (128, 256)), _normal(rng, (256, 128), 0.05)
    b, r = _normal(rng, (128,)), _normal(rng, (128, 128))
    res = r if with_res else None
    ref = jops.fused_gemm_epilogue(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if res is None else jnp.asarray(res), act=act, interpret=True)
    got = ops.linear_fused(_t(x), _t(w), _t(b),
                           None if res is None else _t(res), act=act)
    _close(got, ref, 1e-4)
    _close(got, jref.fused_gemm_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
        residual=None if res is None else jnp.asarray(res)), 1e-4)


@pytest.mark.parametrize("m,k,n", [(256, 512, 384), (128, 1024, 256)])
def test_fused_gemm_epilogue_shapes_against_ref(m, k, n):
    rng = np.random.default_rng(m + n)
    x, w, b = _normal(rng, (m, k)), _normal(rng, (k, n), 0.05), \
        _normal(rng, (n,))
    got = fused_gemm_epilogue(_t(x), _t(w), _t(b), act="gelu")
    _close(got, jref.fused_gemm_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act="gelu"), 1e-4)


def test_fused_gemm_epilogue_bf16():
    rng = np.random.default_rng(5)
    x, w, b = _normal(rng, (128, 256)), _normal(rng, (256, 128), 0.05), \
        _normal(rng, (128,))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w)]
    ref = jops.fused_gemm_epilogue(*jb, jnp.asarray(b), act="silu",
                                   interpret=True)
    got = fused_gemm_epilogue(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                              _t(b), act="silu")
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref, np.float32), 2e-2)


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (128, 1024, 256),
                                   (77, 1001, 19), (130, 514, 258),
                                   (1, 7, 3), (2048, 2048, 2048),
                                   (256, 0, 256), (64, 4096, 64),
                                   (512, 512, 512), (300, 700, 200)])
@pytest.mark.parametrize("size", [4, 2], ids=["float32", "bfloat16"])
def test_fused_k_split_plan_is_shape_only_and_covers_k(m, k, n, size):
    """The kernel's K split: the same for the same shape, shares of a
    multiple of 256 bytes of each row (64 float32 / 128 bfloat16 values)
    that cover K with none empty, as many (at most 8) as keep the blocks
    within the 132 SMs, and forced counts cut to the K there is."""
    unit = 256 // size
    plan = fused_module.k_splits(m, n, k, size)
    assert plan == fused_module.k_splits(m, n, k, size)
    tiles = -(-m // 64) * -(-n // 64)
    for splits, chunk in (plan, fused_module.k_splits(m, n, k, size, 3),
                          fused_module.k_splits(m, n, k, size, 1)):
        assert 1 <= splits <= fused_module.MAX_SPLITS
        assert chunk % unit == 0 and splits * chunk >= k
        assert (splits - 1) * chunk < k or splits == 1
    assert (plan[0] > 1) == (2 * tiles <= 132 and k > unit)
    assert tiles * plan[0] <= 132 or plan[0] == 1
    units = -(-k // unit)
    want = max(1, min(132 // tiles, 8, units))
    per = -(-units // want) if units else 0
    assert plan == ((-(-units // per) if per else 1), per * unit)


@pytest.mark.parametrize("block_m", [128, 64, 96, 32, 48, 100, 24, 7])
@pytest.mark.parametrize("mp_tiles,n", [(7, 256), (32, 1024), (3, 40)])
def test_packed_tile_never_spans_two_row_tiles(block_m, mp_tiles, n):
    """The kernel's block tile: rows the largest of 64/32/16 dividing
    block_m (else the smallest covering it, up to 64, masked at the
    boundary), so no block reads two tiles' weights; 32 columns where 64
    would give under two blocks per SM."""
    tm, tn = packed_module.packed_tile(block_m, mp_tiles * block_m, n)
    divisors = [t for t in (64, 32, 16) if block_m % t == 0]
    assert tm == (divisors[0] if divisors else
                  16 if block_m <= 16 else 32 if block_m <= 32 else 64)
    sub = -(-block_m // tm)
    assert (sub - 1) * tm < block_m <= sub * tm
    blocks_64 = mp_tiles * sub * -(-n // 64)
    assert tn == (32 if blocks_64 < 264 else 64)


def test_fused_gemm_epilogue_rejects_bad_input():
    x, w, b = torch.zeros(4, 8), torch.zeros(8, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="act"):
        fused_gemm_epilogue(x, w, b, act="tanh")
    with pytest.raises(ValueError, match="do not fit"):
        fused_gemm_epilogue(x, w.T, b)
    with pytest.raises(ValueError, match="residual"):
        fused_gemm_epilogue(x, w, b, torch.zeros(4, 3))


# ---------------------------------------------------------------------------
# packed_gemm / grouped_gemm
# ---------------------------------------------------------------------------

GROUP_SIZES = [
    [256, 128, 384],            # already tile-aligned
    [200, 56, 300, 100],        # ragged (padding path)
    [128],                      # single group
    [0, 256, 0, 128],           # empty groups
]


@pytest.mark.parametrize("sizes", GROUP_SIZES, ids=str)
def test_pad_groups_and_tile_map_equal_jax(sizes):
    from repro.kernels.packed_gemm import pad_groups as jax_pad_groups
    from repro.kernels.packed_gemm import tile_group_map as jax_tile_map
    rng = np.random.default_rng(len(sizes))
    x = _normal(rng, (max(sum(sizes), 1), 8))
    jx, jpad, jrow, jinv = jax_pad_groups(jnp.asarray(x), sizes, 128)
    tx, tpad, trow, tinv = pad_groups(_t(x), sizes, 128)
    for got, ref in ((tx, jx), (tpad, jpad), (trow, jrow), (tinv, jinv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tpad.dtype == trow.dtype == tinv.dtype == torch.int32
    n_tiles = tx.shape[0] // 128
    for n in (n_tiles, n_tiles + 2, max(n_tiles - 1, 0)):
        np.testing.assert_array_equal(
            tile_group_map(tpad.numpy(), 128, n).numpy(),
            np.asarray(jax_tile_map(jpad, 128, n)))


@pytest.mark.parametrize("sizes", GROUP_SIZES, ids=str)
def test_grouped_gemm_plain_matches_pallas(sizes):
    G = len(sizes)
    rng = np.random.default_rng(sum(sizes) + G)
    w = _normal(rng, (G, 128, 256), 0.1)
    x = _normal(rng, (max(sum(sizes), 1), 128))
    got = ops.grouped_gemm(_t(x), _t(w), sizes)
    _close(got, jops.grouped_gemm(jnp.asarray(x), jnp.asarray(w), sizes),
           1e-4)
    _close(got, jref.packed_gemm_ref(jnp.asarray(x), jnp.asarray(w),
                                     jnp.array(sizes)), 1e-4)


def test_packed_gemm_tile_map_selects_each_tiles_weight():
    """Tiles need not be sorted: each block_m rows use w[tile_groups[i]];
    block_n only decides which N are accepted."""
    rng = np.random.default_rng(2)
    x, w = _normal(rng, (96, 16)), _normal(rng, (3, 16, 40))
    tiles = torch.tensor([2, 0, 2], dtype=torch.int32)
    got = packed_gemm(_t(x), _t(w), tiles, block_m=32, block_n=40)
    for i, g in enumerate(tiles.tolist()):
        np.testing.assert_allclose(got[32 * i:32 * (i + 1)].numpy(),
                                   x[32 * i:32 * (i + 1)] @ w[g], rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="outside"):
        packed_gemm(_t(x), _t(w), torch.tensor([0, 3, 1]), block_m=32)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        packed_gemm(_t(x), _t(w), tiles, block_m=32, block_n=32)


# ---------------------------------------------------------------------------
# the crossbar wrappers, and their batched plain versions
# ---------------------------------------------------------------------------

def test_crossbar_matmul_int8_and_fb_postops_match_jax_ops():
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (64, 300), dtype=np.int8)
    w = rng.integers(-128, 128, (300, 48), dtype=np.int8)
    for kw in (dict(rows=256), dict(adc_bits=8, rows=256)):
        ref = jops.crossbar_matmul_int8(jnp.asarray(x), jnp.asarray(w), **kw)
        got = ops.crossbar_matmul_int8(torch.from_numpy(x),
                                       torch.from_numpy(w), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    y = np.array(ref)
    scale = np.array([[2.5e-5]], np.float32)
    bias = _normal(rng, (48,))
    jy = jops.fb_postops(jnp.asarray(y), jnp.asarray(scale),
                         jnp.asarray(bias), act="relu")
    ty = ops.fb_postops(torch.from_numpy(y), torch.from_numpy(scale),
                        torch.from_numpy(bias), act="relu")
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("adc_bits,rows", [(9, 64), (5, 64), (8, 300)])
def test_batched_crossbar_gemm_equals_per_slice(adc_bits, rows):
    """(S, M, K) x (S, K, N) is S independent GEMMs: the exact branch
    (9-bit / 64 rows) and the sliced one (5-bit; 8-bit / 300 rows with a
    ragged last chunk), with all-ones rows that clip."""
    rng = np.random.default_rng(rows + adc_bits)
    x = torch.from_numpy(rng.integers(-128, 128, (6, 40, 350),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (6, 350, 24),
                                      dtype=np.int8))
    x[:, :5] = -1
    w[:, :, :3] = -1
    got = crossbar_gemm(x, w, adc_bits=adc_bits, rows=rows)
    assert got.shape == (6, 40, 24) and got.dtype == torch.int32
    for s in range(6):
        assert torch.equal(got[s], crossbar_gemm(x[s], w[s],
                                                 adc_bits=adc_bits,
                                                 rows=rows))


@pytest.mark.parametrize("kw", [dict(softmax=True, post_scale=0.125),
                                dict(post_scale=0.125), dict(act="gelu"),
                                dict(norm="layer"),
                                dict(pool="seqmean", window=8)],
                         ids=["softmax", "post_scale", "gelu", "layer",
                              "seqmean"])
def test_batched_fb_epilogue_equals_per_slice(kw):
    rng = np.random.default_rng(1)
    S, M, N = 5, 16, 24
    y = torch.from_numpy(rng.integers(-2 ** 16, 2 ** 16, (S, M, N),
                                      dtype=np.int32))
    scale = _t(rng.uniform(1e-5, 1e-3, (S, 1, 1)))
    bias = _t(_normal(rng, (N,)))
    if kw.get("norm"):
        kw = dict(kw, gamma=_t(_normal(rng, (N,))),
                  beta=_t(_normal(rng, (N,))))
    got = fb_epilogue(y, scale, bias, **kw)
    assert got.dim() == 3 and got.shape[0] == S
    for s in range(S):
        assert torch.equal(got[s], fb_epilogue(y[s], scale[s], bias, **kw))


@pytest.mark.parametrize("kw,parts", [
    (dict(act="relu"), True), (dict(norm="layer", tap=True), True),
    (dict(softmax=True), True), (dict(heads=2), True),
    (dict(pool="max", window=2, img_hw=4), False),
    (dict(pool="seqmean", window=8), False)],
    ids=["relu", "layer-tap", "softmax", "heads", "maxpool", "seqmean"])
def test_fb_epilogue_partial_maxima_on_the_cpu(kw, parts):
    """With ``partials=True`` the plain version appends one partial
    maximum, ``max |out|``, after the outputs of the call without it
    (None where the chain pools or takes a sequence mean, as the
    kernel's)."""
    rng = np.random.default_rng(2)
    S, M, N = 4, 16, 24
    y = torch.from_numpy(rng.integers(-2 ** 16, 2 ** 16, (S, M, N),
                                      dtype=np.int32))
    scale = _t(rng.uniform(1e-5, 1e-3, (S, 1, 1)))
    bias = None if kw.get("heads") else _t(_normal(rng, (N,)))
    if kw.get("norm"):
        kw = dict(kw, gamma=_t(_normal(rng, (N,))),
                  beta=_t(_normal(rng, (N,))))
    got = fb_epilogue(y, scale, bias, partials=True, **kw)
    plain = fb_epilogue(y, scale, bias, **kw)
    plain = plain if kw.get("tap") else (plain,)
    assert len(got) == len(plain) + 1
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    if parts:
        assert torch.equal(got[-1], got[0].abs().amax().reshape(1))
    else:
        assert got[-1] is None
