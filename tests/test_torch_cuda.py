"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they build the kernels with ``nvcc`` and launch them,
so they skip on a host without a GPU.  On the GPU machine (which has no
JAX) run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch, numpy and repro_torch only.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import (COUNTED, clip_possible, crossbar_gemm,
                                 crossbar_gemm_exact_ref, crossbar_gemm_ref,
                                 fb_epilogue, fb_epilogue_ref,
                                 flash_attention, flash_attention_ref,
                                 fused_gemm_epilogue, fused_gemm_epilogue_ref,
                                 kernel_layout, mount_weight, ops,
                                 packed_gemm, packed_gemm_ref,
                                 packed_gemm_tiles_ref, pad_groups,
                                 quantize_layout, quantize_layout_ref,
                                 tile_group_map)
from test_torch_prenorm import small_graph


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels are CUDA C++)")
    return torch.device("cuda")


def _int8(shape, rng):
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits,rows,exact", [
    (9, 494, None), (9, 27, None), (8, 494, None), (9, 512, None),
    (9, 255, False), (8, 486, False)])
def test_crossbar_gemm_kernel_equals_plain(cuda, adc_bits, rows, exact):
    rng = np.random.default_rng(rows)
    x, w = _int8((133, 1001), rng).to(cuda), _int8((1001, 70), rng).to(cuda)
    x[:33] = -1          # all bits set: bitline counts reach `rows`
    w[:, :17] = -1
    before = crossbar_gemm.launches
    got = crossbar_gemm(x, w, adc_bits=adc_bits, rows=rows, exact=exact)
    assert crossbar_gemm.launches == before + 1
    sliced = exact is False or clip_possible(rows, adc_bits)
    ref = (crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows) if sliced
           else crossbar_gemm_exact_ref(x, w))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# (kwargs, residual?, atol) — 0 is bit for bit: same roundings in the same
# order; elsewhere the kernel's block reductions sum in another order
FB_CASES = {
    "none": (dict(), False, 0.0),
    "relu+residual": (dict(act="relu"), True, 0.0),
    "post_scale": (dict(post_scale=0.125), False, 0.0),
    "maxpool": (dict(act="relu", pool="max", window=2, img_hw=8), True, 0.0),
    "avgpool": (dict(act="relu", pool="avg", window=4, img_hw=8), True, 0.0),
    "gelu": (dict(act="gelu"), False, 1e-6),
    "layer": (dict(norm="layer"), True, 1e-5),
    "seqmean": (dict(act="gelu", norm="layer", pool="seqmean", window=16),
                True, 1e-5),
    "softmax": (dict(softmax=True), False, 1e-6),
}


def _fb_against_plain(device, mode, M, N, seed, **over):
    kw, with_res, atol = FB_CASES[mode]
    kw = dict(kw, **over)
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=g, device=device,
                      dtype=torch.int32)
    scale = torch.full((1, 1), 3.1e-6, device=device)
    bias = torch.randn(N, generator=g, device=device)
    res = torch.randn(M, N, generator=g, device=device) if with_res else None
    if "norm" in kw:
        kw = dict(kw, gamma=torch.randn(N, generator=g, device=device),
                  beta=torch.randn(N, generator=g, device=device))
    before = fb_epilogue.launches
    got = fb_epilogue(y, scale, bias, res, **kw)
    assert fb_epilogue.launches == before + 1
    ref = fb_epilogue_ref(y, scale, bias, res, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


# N: the first width, the program's widths (16-byte accesses) and widths
# that are not multiples of 4 (the scalar path)
@pytest.mark.cuda
@pytest.mark.parametrize("N", [48, 64, 192, 768, 10, 19, 77])
@pytest.mark.parametrize("mode", list(FB_CASES))
def test_fb_epilogue_kernel_matches_plain(cuda, mode, N):
    _fb_against_plain(cuda, mode, 2 * 64, N, seed=0 if N == 48 else N)


# the longest row a warp holds, one past it, and a sequence whose token
# rows do not fit a block's shared memory (64 x 1024): the block-per-row
# path
@pytest.mark.cuda
@pytest.mark.parametrize("mode,N,over", [
    ("layer", 1024, {}), ("layer", 1025, {}), ("softmax", 1024, {}),
    ("softmax", 1025, {}), ("seqmean", 1024, {}), ("seqmean", 1025, {}),
    ("seqmean", 1024, {"window": 64})])
def test_fb_epilogue_long_rows(cuda, mode, N, over):
    _fb_against_plain(cuda, mode, 128, N, seed=N, **over)


# the tap (pre-norm blocks): the row before the layer norm, stored by the
# same launch, bit for bit the plain path's; the normalized rows bit for
# bit those of the call without a tap.  Widths: ViT-S/16's 384, vit_tiny's
# 192, an odd one, and past a warp's row (the block-per-row kernel)
@pytest.mark.cuda
@pytest.mark.parametrize("N", [384, 192, 19, 1000, 1025, 1536])
def test_fb_epilogue_tap_equals_plain(cuda, N):
    kw, _, atol = FB_CASES["layer"]
    M = 3 * 196
    g = torch.Generator(device=cuda).manual_seed(N)
    y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=g, device=cuda,
                      dtype=torch.int32)
    scale = torch.full((1, 1), 3.1e-6, device=cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    res = torch.randn(M, N, generator=g, device=cuda)
    kw = dict(kw, gamma=torch.randn(N, generator=g, device=cuda),
              beta=torch.randn(N, generator=g, device=cuda))
    before = fb_epilogue.launches
    out, tap = fb_epilogue(y, scale, bias, res, tap=True, **kw)
    assert fb_epilogue.launches == before + 1
    untapped = fb_epilogue(y, scale, bias, res, **kw)
    ref_out, ref_tap = fb_epilogue_ref(y, scale, bias, res, tap=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tap, ref_tap)
    assert torch.equal(out, untapped)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=atol)


# a pool window other than the programs' 2 and 4
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["maxpool", "avgpool"])
@pytest.mark.parametrize("N", [64, 19])
def test_fb_epilogue_pool_window_8(cuda, mode, N):
    _fb_against_plain(cuda, mode, 2 * 256, N, seed=8, window=8, img_hw=16)


@pytest.mark.cuda
def test_small_net_on_the_gpu_equals_the_cpu_plain_path(cuda):
    nb = api.NetworkBuilder("tiny", input_hw=8, input_ch=3)
    nb.conv(16, name="c1")
    r1 = nb.relu(name="r1")
    nb.conv(16, name="c2")
    nb.residual(r1, name="res")
    nb.relu(name="r2")
    nb.maxpool(name="p")
    nb.fc(10, name="fc")
    nb.softmax(name="sm")
    graph = nb.build()
    gpu = api.compile(graph, seed=2, device="cuda")
    cpu = api.compile(graph, seed=2, device="cpu")
    x = np.random.default_rng(0).standard_normal((5, 8, 8, 3)).astype(
        np.float32)
    assert torch.equal(gpu.run(x, logits=True).cpu(), cpu.run(x, logits=True))


# crossbar widths other than the 8/8-bit, 9-bit-ADC default, as
# HurryConfig kwargs: narrower operands and ADCs on 512-row arrays (every
# stage with more than 2^adc - 1 rows on the sliced branch), and smaller
# arrays (128 rows: the isaac-128 baseline's).  The JAX tests take them
# from here (this file imports no JAX).
WIDTHS = {
    "w4a4_adc5": dict(input_bits=4, weight_bits=4, adc_bits=5),
    "w8a6_adc5": dict(input_bits=6, weight_bits=8, adc_bits=5),
    "w4a8_adc5": dict(input_bits=8, weight_bits=4, adc_bits=5),
    "w4a4_adc6": dict(input_bits=4, weight_bits=4, adc_bits=6),
    "rows256_adc8": dict(array_rows=256, adc_bits=8),
    "rows128_adc7": dict(array_rows=128, adc_bits=7),
}


def _custom8():
    """tests/test_torch_program.py's custom8: conv, relu, 1x1 projection,
    residual, max pool, avg pool, fc, softmax."""
    nb = api.NetworkBuilder("custom8", input_hw=8, input_ch=4)
    nb.conv(16, name="c1")
    r1 = nb.relu(name="r1")
    proj = nb.conv(24, k=1, padding=0, name="proj", input_from=r1)
    nb.conv(24, name="c2", input_from=r1)
    nb.residual(proj, name="res")
    nb.relu(name="r2")
    nb.maxpool(name="p1")
    nb.conv(32, name="c3")
    nb.relu(name="r3")
    nb.avgpool(k=4, stride=4, name="gap")
    nb.fc(10, name="fc")
    nb.softmax(name="sm")
    return nb.build()


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(WIDTHS))
def test_custom_net_at_other_widths_on_the_card(cuda, width):
    """custom8 at each width: ``run`` on the card ``torch.equal`` to the
    CPU plain path (logits; probabilities to 1e-6), one launch of each
    kernel per stage."""
    graph, cfg = _custom8(), api.HurryConfig(**WIDTHS[width])
    gpu = api.compile(graph, cfg, seed=2, device="cuda")
    cpu = api.compile(graph, cfg, seed=2, device="cpu")
    x = np.random.default_rng(0).standard_normal((5, 8, 8, 4)).astype(
        np.float32)
    before = crossbar_gemm.launches, fb_epilogue.launches
    got = gpu.run(x, logits=True)
    n = len(gpu.program.stages())
    assert (crossbar_gemm.launches, fb_epilogue.launches) == (
        before[0] + n, before[1] + n)
    assert torch.equal(got.cpu(), cpu.run(x, logits=True))
    # the softmax FB sums its row in another order on the card
    torch.testing.assert_close(gpu.run(x).cpu(), cpu.run(x), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits,rows", [(9, 64), (8, 300)])
def test_batched_crossbar_gemm_is_one_launch_equal_to_per_slice(cuda,
                                                                adc_bits,
                                                                rows):
    rng = np.random.default_rng(rows)
    x, w = _int8((6, 64, 350), rng).to(cuda), _int8((6, 350, 40), rng).to(cuda)
    x[:, :8] = -1
    w[:, :, :5] = -1
    before = crossbar_gemm.launches
    got = crossbar_gemm(x, w, adc_bits=adc_bits, rows=rows)
    assert crossbar_gemm.launches == before + 1
    for s in range(6):
        assert torch.equal(got[s], crossbar_gemm(x[s], w[s],
                                                 adc_bits=adc_bits,
                                                 rows=rows))
    ref = crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,atol", [(dict(softmax=True, post_scale=0.125),
                                      1e-6), (dict(post_scale=0.125), 0.0)])
def test_batched_fb_epilogue_is_one_launch_equal_to_per_slice(cuda, kw, atol):
    g = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randint(-2 ** 16, 2 ** 16, (48, 64, 64), generator=g,
                      device=cuda, dtype=torch.int32)
    scale = torch.rand(48, 1, 1, generator=g, device=cuda) * 1e-4
    bias = torch.zeros(64, device=cuda)
    before = fb_epilogue.launches
    got = fb_epilogue(y, scale, bias, **kw)
    assert fb_epilogue.launches == before + 1
    for s in range(48):
        assert torch.equal(got[s], fb_epilogue(y[s], scale[s], bias, **kw))
    torch.testing.assert_close(got, fb_epilogue_ref(y, scale, bias, **kw),
                               rtol=0, atol=atol)


def _randn(shape, g, device, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,dtype,tol,negative", [
    ((1, 128, 1, 64), True, 0, torch.float32, 1e-4, False),
    ((2, 256, 4, 64), False, 0, torch.float32, 1e-4, False),
    ((1, 512, 2, 64), True, 128, torch.float32, 1e-4, False),
    ((1, 256, 2, 64), True, 0, torch.bfloat16, 2e-2, False),
    ((16, 64, 3, 64), False, 0, torch.float32, 1e-4, False),
    ((1, 64, 4, 16), False, 0, torch.float32, 1e-4, False),
    ((1, 48, 2, 128), True, 0, torch.float32, 1e-4, False),
    # a ragged last key tile (48 = 32 + 16) with every score near -800:
    # the keys past Sk must not lift the running max to 0
    ((1, 48, 2, 64), False, 0, torch.float32, 1e-4, True),
    # every head-dim instantiation, ragged key tiles, head dims below the
    # instantiation, rows that are not 16-byte aligned, both sides of the
    # key-split threshold
    ((1, 128, 2, 16), True, 0, torch.float32, 1e-4, False),
    ((2, 128, 2, 32), False, 0, torch.float32, 1e-4, False),
    ((1, 256, 2, 128), False, 0, torch.float32, 1e-4, False),
    ((1, 256, 2, 16), False, 0, torch.bfloat16, 2e-2, False),
    ((1, 128, 2, 32), True, 0, torch.bfloat16, 2e-2, False),
    ((1, 256, 2, 128), True, 0, torch.bfloat16, 2e-2, False),
    ((2, 96, 2, 64), False, 0, torch.float32, 1e-4, False),
    ((1, 80, 2, 128), True, 0, torch.float32, 1e-4, False),
    ((1, 64, 2, 20), False, 0, torch.float32, 1e-4, False),
    ((1, 64, 2, 18), True, 0, torch.float32, 1e-4, False),
    ((1, 128, 1, 20), True, 0, torch.bfloat16, 2e-2, False),
    ((1, 512, 4, 64), False, 0, torch.float32, 1e-4, False),
    ((8, 512, 8, 64), False, 0, torch.float32, 1e-4, False),
    ((1, 512, 4, 64), True, 0, torch.bfloat16, 2e-2, False),
])
def test_flash_attention_kernel_matches_plain(cuda, shape, causal, window,
                                              dtype, tol, negative):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (_randn(shape, g, cuda, dtype) for _ in range(3))
    if negative:
        q, k = q.abs() + 10, -k.abs() - 10
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window,
                          block_q=min(128, shape[1]),
                          block_k=min(128, shape[1]))
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 128)])
def test_flash_attention_key_split_on_and_off(cuda, causal, window):
    """The key split forced off and on: each within 1e-4 of the plain
    version and of the split's plain version, and a split shape gives
    the same output twice."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn((1, 512, 4, 64), g, cuda) for _ in range(3))
    auto = fa.key_splits(1, 4, 512, 512, 64)
    assert auto > 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    for sp in (1, 2, auto):
        got = fa._launch(q, k, v, causal=causal, window=window, splits=sp)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(
            got, fa.flash_attention_split_ref(q, k, v, causal=causal,
                                              window=window, splits=sp),
            rtol=1e-4, atol=1e-4)
    first = fa._launch(q, k, v, causal=causal, window=window, splits=auto)
    again = fa._launch(q, k, v, causal=causal, window=window, splits=auto)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_attention_gqa_on_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    q = _randn((1, 256, 8, 64), g, cuda)
    k, v = _randn((1, 256, 2, 64), g, cuda), _randn((1, 256, 2, 64), g, cuda)
    got = ops.attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k.repeat_interleave(4, 2),
                              v.repeat_interleave(4, 2), causal=True)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("with_res", [False, True])
def test_fused_gemm_epilogue_kernel_matches_plain(cuda, act, dtype, tol,
                                                  with_res):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _randn((256, 512), g, cuda, dtype)
    w = _randn((512, 384), g, cuda, dtype, 0.05)
    b = _randn((384,), g, cuda)
    res = _randn((256, 384), g, cuda) if with_res else None
    before = fused_gemm_epilogue.launches
    got = fused_gemm_epilogue(x, w, b, res, act=act)
    assert fused_gemm_epilogue.launches == before + 1 and got.dtype == dtype
    ref = fused_gemm_epilogue_ref(x, w, b, act=act, residual=res)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[256, 128, 384], [200, 56, 300, 100],
                                   [128], [0, 256, 0, 128]], ids=str)
def test_grouped_gemm_kernel_matches_plain(cuda, sizes):
    g = torch.Generator(device=cuda).manual_seed(sum(sizes))
    w = _randn((len(sizes), 128, 256), g, cuda, scale=0.1)
    x = _randn((sum(sizes), 128), g, cuda)
    xp, padded, _, _ = pad_groups(x, sizes, 128)
    tiles = tile_group_map(padded, 128, xp.shape[0] // 128)
    before = packed_gemm.launches
    got = packed_gemm(xp, w, tiles)
    assert packed_gemm.launches == before + 1
    torch.testing.assert_close(got, packed_gemm_tiles_ref(xp, w, tiles, 128),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ops.grouped_gemm(x, w, sizes),
                               packed_gemm_ref(x, w, sizes), rtol=1e-4,
                               atol=1e-4)


_fused_module = importlib.import_module(
    "repro_torch.kernels.fused_gemm_epilogue")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 7, 3), (77, 1001, 19), (130, 514, 258),
                                   (64, 33, 66), (3, 64, 1), (4, 0, 9)],
                         ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_fused_gemm_epilogue_ragged_and_unaligned(cuda, shape, dtype, tol):
    """Shapes no tile divides, rows that are not 16-byte aligned (K or N
    not a multiple of 4 floats / 8 bf16: synchronous loads), odd N
    (scalar stores), both sides of the K split, and K = 0 (the epilogue
    on a zero product)."""
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = _randn((M, K), g, cuda, dtype)
    w = _randn((K, N), g, cuda, dtype, 0.05)
    b, res = _randn((N,), g, cuda), _randn((M, N), g, cuda)
    for act in ("silu", "gelu"):
        got = fused_gemm_epilogue(x, w, b, res, act=act)
        ref = fused_gemm_epilogue_ref(x, w, b, act=act, residual=res)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, N)
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_fused_gemm_epilogue_split_k_on_and_off(cuda, dtype, tol):
    """256x512x256 (the kernel bench's shape) splits K; forced off, on
    and to an uneven 3 it stays within tolerance, and a split shape
    gives the same output twice (the partials meet in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = _randn((256, 512), g, cuda, dtype)
    w = _randn((512, 256), g, cuda, dtype, 0.05)
    b, res = _randn((256,), g, cuda), _randn((256, 256), g, cuda)
    auto, _ = _fused_module.k_splits(256, 256, 512, x.element_size())
    assert auto > 1
    ref = fused_gemm_epilogue_ref(x, w, b, act="relu", residual=res)
    for sp in (1, 3, auto):
        got = _fused_module._launch(x, w, b, res, "relu", splits=sp)
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    first = _fused_module._launch(x, w, b, res, "relu")
    again = _fused_module._launch(x, w, b, res, "relu")
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 256), (100, 200, 72)], ids=str)
def test_fused_gemm_epilogue_reads_bf16_bias_and_residual(cuda, shape):
    """A bf16 bias and residual go to the kernel in their own type: the
    output equals the one from their float32 copies (bf16 -> float32 is
    exact) and the plain version's."""
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(9)
    x = _randn((M, K), g, cuda, torch.bfloat16)
    w = _randn((K, N), g, cuda, torch.bfloat16, 0.05)
    b = _randn((N,), g, cuda, torch.bfloat16)
    res = _randn((M, N), g, cuda, torch.bfloat16)
    got = fused_gemm_epilogue(x, w, b, res, act="gelu")
    same = fused_gemm_epilogue(x, w, b.float(), res.float(), act="gelu")
    ref = fused_gemm_epilogue_ref(x, w, b, act="gelu", residual=res)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, same)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[200, 56, 300, 100], [0, 256, 0, 128]],
                         ids=str)
def test_grouped_gemm_kernel_bf16(cuda, sizes):
    g = torch.Generator(device=cuda).manual_seed(sum(sizes) + 1)
    w = _randn((len(sizes), 128, 256), g, cuda, torch.bfloat16, 0.1)
    x = _randn((sum(sizes), 128), g, cuda, torch.bfloat16)
    xp, padded, _, _ = pad_groups(x, sizes, 128)
    tiles = tile_group_map(padded, 128, xp.shape[0] // 128)
    got = packed_gemm(xp, w, tiles)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), packed_gemm_tiles_ref(xp, w, tiles, 128).float(),
        rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(ops.grouped_gemm(x, w, sizes).float(),
                               packed_gemm_ref(x, w, sizes).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("block_m", [32, 96, 100, 24])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_packed_gemm_block_m_and_unsorted_map(cuda, block_m, dtype, tol):
    """Row tiles of 32 / 96 rows (a 32-row block tile) and of 100 / 24
    rows (no block tile divides them: the kernel masks at each tile's
    end), a tile map that is not sorted, K and N not 16-byte multiples."""
    g = torch.Generator(device=cuda).manual_seed(block_m)
    tiles = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    x = _randn((4 * block_m, 72), g, cuda, dtype)
    for K, N in ((72, 40), (37, 19)):
        xk = x[:, :K].contiguous()
        w = _randn((3, K, N), g, cuda, dtype, 0.1)
        got = packed_gemm(xk, w, tiles, block_m=block_m, block_n=N)
        ref = packed_gemm_tiles_ref(xk, w, tiles, block_m)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_vit_on_the_gpu_matches_the_cpu_plain_path(cuda):
    graph = api.vit_tiny_graph(depth=1, dim=48, heads=3)
    gpu = api.compile(graph, seed=2, device="cuda")
    cpu = api.compile(graph, seed=2, device="cpu")
    x = np.random.default_rng(0).standard_normal(graph.input_shape(3)).astype(
        np.float32)
    n_dyn = sum(g.kind == "dyn_gemm" for g, _ in gpu.program.stages())
    before = crossbar_gemm.launches
    got = gpu.run(x, logits=True).cpu()
    assert crossbar_gemm.launches == before + len(gpu.program.stages())
    assert n_dyn == 2
    ref = cpu.run(x, logits=True)
    assert (got.argmax(1) == ref.argmax(1)).all()
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=2e-2 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# crossbar_gemm on wgmma: edge shapes, extreme operands, the K split
# ---------------------------------------------------------------------------

_gemm_module = importlib.import_module("repro_torch.kernels.crossbar_gemm")


def _saturated(M, K, N, rng, cuda):
    """Random int8 operands with a quarter of x's rows and w's columns all
    ones (-1), so that bitline counts reach ``rows`` and clip."""
    x, w = _int8((M, K), rng).to(cuda), _int8((K, N), rng).to(cuda)
    x[: max(1, M // 4)] = -1
    w[:, : max(1, N // 4)] = -1
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("N", [10, 19, 77])
@pytest.mark.parametrize("K", [27, 101, 988, 1458, 4860])
@pytest.mark.parametrize("M", [1, 4, 16])
def test_crossbar_gemm_exact_edge_shapes(cuda, M, K, N):
    rng = np.random.default_rng(M * 10007 + K * 31 + N)
    x, w = _int8((M, K), rng).to(cuda), _int8((K, N), rng).to(cuda)
    got = crossbar_gemm(x, w, rows=511)
    torch.cuda.synchronize()
    assert torch.equal(got, crossbar_gemm_exact_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("rows", [247, 486, 494, 511, 512])
def test_crossbar_gemm_sliced_edge_rows(cuda, rows, M):
    """Chunks of every height the program and the smoke run use, each
    padded to a multiple of 32 rows inside the kernel layout; clips fire
    wherever they can (rows > 255 under an 8-bit ADC)."""
    rng = np.random.default_rng(rows + M)
    x, w = _saturated(M, 1458, 77, rng, cuda)
    got = crossbar_gemm(x, w, adc_bits=8, rows=rows, exact=False)
    ref = crossbar_gemm_ref(x, w, adc_bits=8, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    clipped = not torch.equal(ref, crossbar_gemm_exact_ref(x, w))
    assert clipped == clip_possible(rows, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [-128, -1])
@pytest.mark.parametrize("exact", [True, False])
def test_crossbar_gemm_extreme_operands(cuda, fill, exact):
    """All -128 gives the largest |y| (K * 2^14); all -1 sets every bit, so
    every count equals the chunk height and the clip fires in every
    chunk on the sliced branch."""
    M, K, N = 16, 4860, 77
    x = torch.full((M, K), fill, dtype=torch.int8, device=cuda)
    w = torch.full((K, N), fill, dtype=torch.int8, device=cuda)
    kw = dict(rows=511, adc_bits=9) if exact else dict(rows=494, adc_bits=8)
    got = crossbar_gemm(x, w, exact=exact, **kw)
    ref = (crossbar_gemm_exact_ref(x, w) if exact
           else crossbar_gemm_ref(x, w, **kw))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if exact and fill == -128:
        assert int(got[0, 0]) == K * 2 ** 14


@pytest.mark.cuda
@pytest.mark.parametrize("exact,M,K,N,rows,adc_bits", [
    (True, 256, 4860, 512, 486, 9),      # ResNet-18 stage 4 at b16
    (True, 1, 4860, 10, 486, 9),
    (False, 4, 4374, 1024, 486, 8),      # AlexNet fc6 at b4
    (False, 16, 2470, 77, 494, 8)])
def test_crossbar_gemm_split_k_on_and_off(cuda, exact, M, K, N, rows,
                                          adc_bits):
    """The same shape with the K split the kernel picks (> 1 here) and
    with none: both equal to the plain version, bit for bit."""
    rng = np.random.default_rng(M + K + N)
    x, w = _saturated(M, K, N, rng, cuda)
    wt = mount_weight(w, rows=rows, adc_bits=adc_bits, exact=exact)
    xk = kernel_layout(x, K, rows=rows, adc_bits=adc_bits, exact=exact)
    r32 = -(-min(rows, K) // 32) * 32
    assert _gemm_module.splits(1, M, N, wt.shape[-1], exact=exact,
                               rows32=r32) > 1
    ref = (crossbar_gemm_exact_ref(x, w) if exact
           else crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows))
    for split in (0, 1):
        got = _gemm_module._launch(xk.contiguous(), wt, N, exact=exact,
                                   rows=min(rows, K), adc_bits=adc_bits,
                                   split=split)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"split={split}"


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits,rows", [(9, 64), (5, 64), (8, 247),
                                           (9, 511)])
def test_batched_crossbar_gemm_edge_shapes(cuda, adc_bits, rows):
    """The slice axis at ragged M, N and K, through a mounted weight."""
    rng = np.random.default_rng(rows * adc_bits)
    S, M, K, N = 5, 16, 1001, 19
    x, w = _int8((S, M, K), rng).to(cuda), _int8((S, K, N), rng).to(cuda)
    x[:, :3] = -1
    w[:, :, :4] = -1
    wt = mount_weight(w, rows=rows, adc_bits=adc_bits)
    before = crossbar_gemm.launches
    got = crossbar_gemm(x, w, adc_bits=adc_bits, rows=rows, wt=wt)
    assert crossbar_gemm.launches == before + 1
    ref = crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    for s in range(S):
        assert torch.equal(got[s], crossbar_gemm(x[s], w[s],
                                                 adc_bits=adc_bits,
                                                 rows=rows))


# ---------------------------------------------------------------------------
# the rest of repro_torch.api on the card: the functional model, save/load,
# the server, the graph oracle
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,adc_bits,K", [
    (512, 9, 27), (512, 9, 1001), (256, 9, 777), (494, 8, 1001),
    (255, 8, 300), (512, 8, 4860)])
def test_crossbar_matmul_on_the_card_equals_the_cpu(cuda, rows, adc_bits, K):
    """Noise-free 8-bit calls, leading dims and operands outside int8: one
    crossbar_gemm launch each (2-D and sliced), equal to the CPU."""
    from repro_torch.core.crossbar import CrossbarConfig, crossbar_matmul
    rng = np.random.default_rng(K + rows)
    x = torch.from_numpy(rng.integers(-300, 300, (2, 5, K), dtype=np.int32))
    w = torch.from_numpy(rng.integers(-300, 300, (K, 19), dtype=np.int32))
    x[0, :2] = -1
    w[:, :5] = -1
    cfg = CrossbarConfig(rows=rows, adc_bits=adc_bits)
    before = crossbar_gemm.launches
    got = crossbar_matmul(x.to(cuda), w.to(cuda), cfg)
    assert crossbar_gemm.launches == before + 1
    xs, ws = x[0][None].expand(3, -1, -1), w[None].expand(3, -1, -1)
    got_s = crossbar_matmul(xs.to(cuda), ws.to(cuda), cfg)
    assert crossbar_gemm.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), crossbar_matmul(x, w, cfg))
    assert torch.equal(got_s.cpu(), crossbar_matmul(xs, ws, cfg))


@pytest.mark.cuda
def test_noisy_crossbar_matmul_runs_on_the_card(cuda):
    """Read noise and other bit widths take the plain model on the card:
    seeded draws repeat, no kernel launch."""
    from repro_torch.core.crossbar import CrossbarConfig, crossbar_matmul
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-128, 128, (8, 256),
                                      dtype=np.int32)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (256, 32),
                                      dtype=np.int32)).to(cuda)
    cfg = CrossbarConfig(rows=256, noise_sigma_thermal=2.0)
    before = crossbar_gemm.launches

    def draw(seed):
        return crossbar_matmul(x, w, cfg, torch.Generator(cuda).manual_seed(
            seed))

    a, b = draw(3), draw(3)
    exact = (x.double() @ w.double()).to(torch.int32)
    assert torch.equal(a, b) and not torch.equal(a, exact)
    cfg4 = CrossbarConfig(input_bits=4, rows=300, adc_bits=8)
    assert torch.equal(crossbar_matmul(x, w, cfg4).cpu(),
                       crossbar_matmul(x.cpu(), w.cpu(), cfg4))
    assert crossbar_gemm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["alexnet", "vit_tiny"])
def test_save_load_and_server_on_the_card(cuda, net, tmp_path):
    """A model saved on the card and loaded onto it, and a server on the
    same weights, answer batch 5 as the in-memory model does."""
    from repro_torch.program.serve import make_server
    model = api.compile(net, api.HurryConfig(), seed=2, device="cuda")
    loaded = api.load(model.save(str(tmp_path / "m.npz")), device="cuda")
    server = make_server(model.graph, model.params, config=model.config,
                         device="cuda")
    x = torch.randn(model.program.input_shape(5), device=cuda)
    want = model.run(x)
    assert torch.equal(loaded.run(x), want)
    assert torch.equal(server(x), want)
    for a, b in zip(loaded.packed.stages, model.packed.stages):
        assert (a.wt is None) == (b.wt is None)
        assert a.wt is None or torch.equal(a.wt, b.wt)


# ---------------------------------------------------------------------------
# the front door's one executable per (bucket, flavor, input shape)
# ---------------------------------------------------------------------------

def _token_graph():
    """A token-input graph (runtime T): attention, residual, layer norm,
    MLP with GELU, sequence mean, fc, softmax."""
    nb = api.NetworkBuilder("tok", input_seq_dim=32)
    nb.attention(4, name="attn")
    nb.residual("input", name="r1")
    ln = nb.layernorm(name="ln1")
    nb.linear(64, name="fc1")
    nb.gelu(name="g1")
    nb.linear(32, name="fc2")
    nb.residual(ln, name="r2")
    nb.layernorm(name="ln2")
    nb.seqpool(name="pool")
    nb.fc(10, name="head")
    nb.softmax(name="sm")
    return nb.build()


# name -> (graph, HurryConfig kwargs, token lengths: () for image input)
EXECUTABLE_CASES = {
    "custom8": (_custom8, {}, ()),
    "alexnet-adc8": (lambda: api.GRAPHS["alexnet"](), dict(adc_bits=8), ()),
    "vit": (lambda: api.vit_tiny_graph(depth=1, dim=48, heads=3), {}, ()),
    "tokens": (_token_graph, {}, (16, 32)),
    # pre-norm blocks: a tap a stage, stored by the captured epilogues
    "vit-prenorm": (small_graph, {}, ()),
}


def _eager(model, x, logits):
    """``execute_packed`` itself on the padded batch, sliced back: what a
    replay of ``run`` must equal."""
    from repro_torch.program.execute import execute_packed
    from repro_torch.program.serve import bucket_batch, pad_batch
    b = x.shape[0]
    x = pad_batch(x, bucket_batch(b, model.buckets))
    return execute_packed(model.packed, x, return_logits=logits)[:b]


@pytest.mark.cuda
@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("case", list(EXECUTABLE_CASES))
def test_run_replays_one_graph_per_key(cuda, case, logits):
    """Batches 1, 3 and 16 (buckets 1, 4, 16; token graphs at two T):
    the first request of a key captures, the second replays; both equal
    eager ``execute_packed`` on their own input (the first still after
    the second ran: no aliasing), and the counters grow by one launch of
    each kernel per stage and request."""
    make, cfg, seqs = EXECUTABLE_CASES[case]
    graph = make()
    model = api.compile(graph, api.HurryConfig(**cfg), seed=2, device="cuda")
    n = len(model.program.stages())
    g = torch.Generator(device=cuda).manual_seed(7)
    keys = 0
    for seq in seqs or (16,):
        for b in (1, 3, 16):
            shape = model.program.input_shape(b, seq_len=seq)
            x1 = torch.randn(shape, generator=g, device=cuda)
            x2 = torch.randn(shape, generator=g, device=cuda)
            before = crossbar_gemm.launches, fb_epilogue.launches
            first = model.run(x1, logits=logits)
            second = model.run(x2, logits=logits)
            assert (crossbar_gemm.launches, fb_epilogue.launches) == (
                before[0] + 2 * n, before[1] + 2 * n)
            keys += 1
            assert len(model._fns) == keys
            assert torch.equal(second, _eager(model, x2, logits))
            assert torch.equal(first, _eager(model, x1, logits))
            assert first.shape == (b, 10)


# a capture that cannot be made: run in a process of its own, so that
# whatever the failed capture leaves in the CUDA context stays there
_FAILED_CAPTURE = """
import torch
from repro_torch import api
from repro_torch.kernels import crossbar_gemm, fb_epilogue
import repro_torch.program.serve as serve
nb = api.NetworkBuilder("tiny", input_hw=8, input_ch=3)
nb.conv(16, name="c1"); nb.relu(name="r1"); nb.fc(10, name="fc")
model = api.compile(nb.build(), seed=2, device="cuda")
eager = serve.execute_packed
def syncs(packed, x, **kw):
    out = eager(packed, x, **kw)
    if torch.cuda.is_current_stream_capturing():
        out.sum().item()              # a host read: not capturable
    return out
serve.execute_packed = syncs
before = crossbar_gemm.launches, fb_epilogue.launches
try:
    model.run(torch.randn(2, 8, 8, 3, device="cuda"))
except RuntimeError:                 # torch.AcceleratorError among them
    print("raised")
print("entries", len(model._fns))
print("counters", (crossbar_gemm.launches, fb_epilogue.launches) == before)
"""


@pytest.mark.cuda
def test_warmup_captures_and_a_failed_capture_raises(cuda):
    """``warmup`` captures its key (a later ``run`` of it captures no
    other); a capture that cannot be made raises, leaves no entry and
    puts the counters back."""
    import os
    import subprocess
    import sys
    model = api.compile(_custom8(), seed=2, device="cuda")
    model.warmup(batch=3, logits=True)
    assert len(model._fns) == 1
    x = torch.randn(model.program.input_shape(4), device=cuda)
    assert torch.equal(model.run(x, logits=True), _eager(model, x, True))
    assert len(model._fns) == 1
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.split("\n")[:3] == [
        "raised", "entries 0", "counters True"], out.stderr


@pytest.mark.cuda
def test_graph_forward_on_the_card(cuda):
    """The crossbar oracle for AlexNet (ReLU / max pool only) on the card
    equals the same call on the CPU, with one crossbar_gemm launch per
    GEMM layer."""
    from repro_torch.models.cnn import make_crossbar_matmul
    graph = api.GRAPHS["alexnet"]()
    params = graph.init_params(torch.Generator().manual_seed(1))
    gparams = {k: {n: t.to(cuda) for n, t in p.items()}
               for k, p in params.items()}
    x = torch.randn(graph.input_shape(4), generator=torch.Generator()
                    .manual_seed(2))
    mm = make_crossbar_matmul(api.HurryConfig().crossbar())
    before = crossbar_gemm.launches
    got = graph.forward(gparams, x.to(cuda), mm=mm, logits=True)
    n_gemm = sum(l.kind in ("conv", "fc") for l in graph.layers)
    assert crossbar_gemm.launches == before + n_gemm
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), graph.forward(params, x, mm=mm,
                                                logits=True))


def _lm_logits(cfg, params, tokens, frames, steps):
    """Float32 forward logits and ``steps`` teacher-forced decode steps'."""
    from repro_torch.models import lm
    f32 = torch.float32
    fwd = lm.forward(params, cfg, tokens, encoder_input=frames,
                     compute_dtype=f32)
    states = None if frames is None else lm.encode(params, cfg, frames, f32)
    caches = lm.init_caches(cfg, tokens.shape[0], steps, dtype=f32,
                            params=params)
    outs = []
    for i in range(steps):
        lg, caches = lm.decode_step(params, cfg, tokens[:, i:i + 1], caches,
                                    i, encoder_states=states,
                                    compute_dtype=f32)
        outs.append(lg)
    return fwd, torch.cat(outs, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_8b", "mixtral_8x22b", "zamba2_2_7b",
                                  "xlstm_1_3b", "whisper_medium"])
def test_lm_on_the_card_equals_the_cpu(cuda, arch):
    """One reduced arch per family (dense, moe, hybrid, ssm, audio): the
    float32 forward and 16 teacher-forced decode steps on the card within
    1e-4 of max |logit| of the same weights on the CPU, and no kernel of
    ``repro_torch.kernels`` launched (the LM path is plain PyTorch)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(3)
    params = lm.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    frames = (torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
              if cfg.is_encdec else None)
    want = _lm_logits(cfg, params, tokens, frames, 16)
    kernels = COUNTED
    before = [k.launches for k in kernels]
    got = _lm_logits(cfg, _to(params, cuda), tokens.to(cuda),
                     None if frames is None else frames.to(cuda), 16)
    assert [k.launches for k in kernels] == before
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


# (arch, config fields replaced, steps): one reduced arch per family, and
# Mixtral with its window cut to 8 decoding past it through the ring
DECODE_REPLAY_CASES = {a: (a, {}, 16) for a in (
    "qwen3_8b", "mixtral_8x22b", "zamba2_2_7b", "xlstm_1_3b",
    "whisper_medium")}
DECODE_REPLAY_CASES["mixtral ring"] = ("mixtral_8x22b",
                                       dict(sliding_window=8), 24)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_REPLAY_CASES))
def test_compiled_decode_step_replays_equal_the_eager_step(cuda, case):
    """``compile_decode_step`` on the card: a teacher-forced loop (bfloat16
    compute, float32 weights cast in the graph) captures one executable
    and replays it; every step's ids and logits and the last caches
    ``torch.equal`` to the eager step's, each kept answer unmoved by the
    later replays, the first caches left as they were."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.step import compile_decode_step, make_decode_step
    from repro_torch.tree import tree_leaves
    arch, replace, steps = DECODE_REPLAY_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    gen = torch.Generator(cuda).manual_seed(11)
    params = lm.init_params(cfg, gen, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, steps), generator=gen,
                           device=cuda, dtype=torch.int32)
    enc = (torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=cuda).to(torch.bfloat16)
           if cfg.is_encdec else None)
    init = lm.init_caches(cfg, 2, steps, params=params)
    kept = _to(init, "cpu")
    eager, compiled = make_decode_step(cfg), compile_decode_step(cfg)
    want, got = [], []
    caches = {"eager": init, "compiled": init}
    for i in range(steps):
        for name, step, out in (("eager", eager, want),
                                ("compiled", compiled, got)):
            nxt, logits, caches[name] = step(
                params, tokens[:, i:i + 1], caches[name],
                torch.tensor(i, dtype=torch.int32, device=cuda),
                encoder_states=enc)
            out.append((nxt, logits))
    assert len(compiled.executables) == 1
    for i, ((gn, gl), (wn, wl)) in enumerate(zip(got, want)):
        assert torch.equal(gn, wn) and torch.equal(gl, wl), i
    for a, b in zip(tree_leaves(caches["compiled"]),
                    tree_leaves(caches["eager"])):
        assert torch.equal(a, b)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(init), tree_leaves(kept)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "whisper_medium"])
def test_launch_serve_captures_once_per_key(cuda, arch, capsys):
    """``launch.serve`` on the card by default: two rounds of fresh caches
    share one key, so one capture serves both."""
    from repro_torch.launch import serve
    r = serve.main(["--arch", arch, "--batch", "2", "--rounds", "2",
                    "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert r["captures"] == 1 and r["tokens"] == 16
    assert "decode step: 1 CUDA graph capture(s) over 2 rounds" in out


@pytest.mark.cuda
def test_quant_kv_cache_updates_on_the_card(cuda):
    """The int8 KV cache's ring on the card: after every update (one-token
    steps past two wraps, and a 3-token append whose slot is clipped back
    to fit) each field ``torch.equal`` to the CPU's, and
    ``read_quant_cache`` equal."""
    from repro_torch.configs import get_config
    from repro_torch.serve.kv_quant import (init_quant_kv_cache,
                                            read_quant_cache,
                                            update_quant_cache)
    cfg = get_config("qwen3_8b").reduced()
    gen = torch.Generator().manual_seed(5)
    caches = {d: init_quant_kv_cache(2, 6, cfg, device=d)
              for d in ("cpu", "cuda")}
    for i in range(15):
        s = 3 if i == 11 else 1
        k = torch.randn((2, s, cfg.n_kv_heads, cfg.resolved_head_dim),
                        generator=gen) * 3
        v = torch.randn(k.shape, generator=gen)
        for d in caches:
            caches[d] = update_quant_cache(caches[d], k.to(d), v.to(d))
        for f, t in caches["cpu"].items():
            assert torch.equal(caches["cuda"][f].cpu(), t), (i, f)
    assert int(caches["cuda"]["index"]) == 17
    for a, b in zip(read_quant_cache(caches["cuda"], torch.float32),
                    read_quant_cache(caches["cpu"], torch.float32)):
        assert torch.equal(a.cpu(), b)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _f32_value_and_grad(cfg, params, batch):
    """Float32-compute next-token loss and its gradient per leaf path."""
    from repro_torch.models import lm
    from repro_torch.train.step import cross_entropy
    from repro_torch.tree import tree_from_items, tree_items
    leaves = {k: v.detach().requires_grad_() for k, v in tree_items(params)}
    logits = lm.forward(tree_from_items(params, leaves), cfg,
                        batch["tokens"], encoder_input=batch.get("frames"),
                        compute_dtype=torch.float32)
    loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                         cfg.vocab_size)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.item(), {k: (torch.zeros_like(v) if g is None else g).cpu()
                         for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b",
                                  "zamba2_2_7b", "xlstm_1_3b",
                                  "whisper_medium"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One reduced arch per family, as ``chip_smoke.py`` phase 22 (a):
    float32-compute loss within 1e-5 relative and every gradient leaf
    within 1e-4 of that leaf's max |grad| of the CPU's on the same
    weights; one ``make_train_step`` step (bfloat16 compute, remat) whose
    gradients correlate with the CPU's at 0.99 or more; no kernel of
    ``repro_torch.kernels`` launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import make_grad_fn, make_train_step
    from repro_torch.tree import tree_items
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(5)
    params = lm.init_params(cfg, gen, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen, dtype=torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    kernels = COUNTED
    before = [k.launches for k in kernels]
    params_d, batch_d = _to(params, cuda), _to(batch, cuda)
    loss_c, grads_c = _f32_value_and_grad(cfg, params, batch)
    loss_d, grads_d = _f32_value_and_grad(cfg, params_d, batch_d)
    assert abs(loss_d / loss_c - 1) <= 1e-5
    for k, w in grads_c.items():
        assert (grads_d[k] - w).abs().max() <= 1e-4 * w.abs().max(), k
    _, state, m = make_train_step(cfg)(params_d, init_opt_state(params_d),
                                       batch_d)
    assert int(state["step"]) == 1 and torch.isfinite(m["loss"])
    x = torch.cat([g.flatten().double().cpu() for _, g in
                   tree_items(make_grad_fn(cfg)(params_d, batch_d)[1])])
    y = torch.cat([g.flatten().double() for _, g in
                   tree_items(make_grad_fn(cfg)(params, batch)[1])])
    assert torch.corrcoef(torch.stack([x, y]))[0, 1] >= 0.99
    assert [k.launches for k in kernels] == before


def _tree_gap(got, want) -> float:
    """Largest leaf gap over that leaf's max |value| (0 where equal)."""
    from repro_torch.tree import tree_items
    worst = 0.0
    for (k, g), (_, w) in zip(tree_items(got), tree_items(want)):
        gap = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        worst = max(worst, gap / scale if scale else gap)
    return worst


def _train_runs(cfg, params, batches, compiled, microbatches=1):
    """The eager step over ``batches`` and ``compiled`` (a
    ``compile_train_step``) from the same state: each run's metrics per
    step and final (params, opt_state)."""
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    eager = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2),
                            microbatches)
    out = {}
    for name, step in (("eager", eager), ("again", eager),
                       ("compiled", compiled)):
        p, o, ms = params, init_opt_state(params), []
        for b in batches:
            p, o, m = step(p, o, b)
            ms.append(m)
        out[name] = dict(metrics=ms, state={"params": p, "opt": o})
    return out


# (arch, microbatches): two dense archs, an MoE arch (top-2 combine by
# index_add_ atomics), and two microbatches unrolled into the graph
TRAIN_REPLAY_CASES = {"internlm2_1_8b": ("internlm2_1_8b", 1),
                      "qwen3_8b": ("qwen3_8b", 1),
                      "mixtral_8x22b": ("mixtral_8x22b", 1),
                      "internlm2 microbatches 2": ("internlm2_1_8b", 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_REPLAY_CASES))
def test_compiled_train_step_replays_equal_the_eager_step(cuda, case):
    """``compile_train_step`` on the card (bfloat16 compute, remat): three
    steps from the same state as two eager runs: one capture, every
    step's metrics and the final parameters, ``m``, ``v`` and ``step``
    ``torch.equal`` to the eager step's, or, where the two eager runs
    differ (atomics), within twice their gap; the state first given is
    left as it was."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import compile_train_step
    from repro_torch.tree import tree_leaves
    arch, micro = TRAIN_REPLAY_CASES[case]
    cfg = get_config(arch).reduced()
    gen = torch.Generator(cuda).manual_seed(12)
    params = lm.init_params(cfg, gen, device=cuda)
    kept = _to(params, "cpu")
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                        generator=gen, device=cuda,
                                        dtype=torch.int32)}
               for _ in range(3)]
    compiled = compile_train_step(
        cfg, OptimizerConfig(lr=1e-3, warmup_steps=2), micro)
    runs = _train_runs(cfg, params, batches, compiled, micro)
    assert len(compiled.executables) == 1
    gaps = {}
    for name in ("again", "compiled"):
        got, want = runs[name], runs["eager"]
        gaps[name] = max([_tree_gap(got["state"], want["state"])]
                         + [_tree_gap(g, w) for g, w in
                            zip(got["metrics"], want["metrics"])])
    assert gaps["compiled"] <= 2 * gaps["again"], gaps
    assert int(runs["compiled"]["state"]["opt"]["step"]) == 3
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(params), tree_leaves(kept)))


@pytest.mark.cuda
def test_compiled_train_step_copies_a_foreign_state_in(cuda, tmp_path):
    """A state the executable does not own (restored from a checkpoint,
    as ``launch.train`` resumes) is copied in without a new capture and
    the replay continues from it, ``torch.equal`` to the eager step; the
    trees returned are the executable's own (the next call overwrites
    them) and each step's metrics are its own tensors; a call under a
    mesh context raises."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.sharding import context as shctx
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import compile_train_step, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config("qwen3_8b").reduced()
    gen = torch.Generator(cuda).manual_seed(13)
    params = lm.init_params(cfg, gen, device=cuda)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                        generator=gen, device=cuda,
                                        dtype=torch.int32)}
               for _ in range(4)]
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    eager, compiled = make_train_step(cfg, ocfg), compile_train_step(cfg,
                                                                     ocfg)
    p, o, m0 = compiled(params, init_opt_state(params), batches[0])
    kept = m0["loss"].clone()
    p1, o1, m1 = compiled(p, o, batches[1])
    assert p1 is p and o1 is o and torch.equal(m0["loss"], kept)
    ep, eo, _ = eager(params, init_opt_state(params), batches[0])
    ep, eo, _ = eager(ep, eo, batches[1])
    save_checkpoint(str(tmp_path), 2, ep, eo, {"seed": 0, "step": 2})
    rp, ro, _ = restore_checkpoint(str(tmp_path), 2, ep, eo)
    got_p, got_o, got_m = compiled(rp, ro, batches[2])
    want_p, want_o, want_m = eager(ep, eo, batches[2])
    assert len(compiled.executables) == 1 and got_p is p
    for a, b in zip(tree_leaves(dict(p=got_p, o=got_o, m=got_m)),
                    tree_leaves(dict(p=want_p, o=want_o, m=want_m))):
        assert torch.equal(a, b)
    with shctx.use_rules(types.SimpleNamespace(mesh="mesh")):
        with pytest.raises(RuntimeError, match="mesh"):
            compiled(got_p, got_o, batches[3])


@pytest.mark.cuda
def test_launch_train_captures_once_per_process(cuda, tmp_path, capsys):
    """``launch.train --reduced`` on the card by default: one capture for
    its steps, and one again when a relaunch resumes from the checkpoint
    it left."""
    from repro_torch.launch import train as launch_train
    args = ["--reduced", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    r = launch_train.main([*args, "--steps", "2"])
    assert r == dict(steps=2, captures=1)
    r = launch_train.main([*args, "--steps", "4"])
    out = capsys.readouterr().out
    assert r == dict(steps=2, captures=1) and "[resume] step 2" in out
    assert "train step: 1 CUDA graph capture(s) over 2 steps" in out


# ---------------------------------------------------------------------------
# the examples (examples/*_torch.py) on the card, at a small size
# ---------------------------------------------------------------------------

def _example(name):
    import contextlib
    import importlib.util
    import io
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def quiet(fn, *args, **kw):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kw)
    return mod, quiet


@pytest.mark.cuda
def test_quickstart_example_custom_on_the_card(cuda):
    """The custom net by default on the card: bit-exact against the
    functional forward and through save/load, one launch of each kernel
    per stage in ``run``."""
    quick, quiet = _example("quickstart_torch")
    r = quiet(quick.main, ["--net", "custom", "--batch", "3"])
    assert r["device"].startswith("cuda")
    assert r["exact"] and r["roundtrip"]
    assert r["launches"] == {"crossbar_gemm": r["stages"],
                             "fb_epilogue": r["stages"]}


@pytest.mark.cuda
def test_crossbar_inference_example_on_the_card(cuda):
    """AlexNet at batch 2: the clean forward launches ``crossbar_gemm``
    once per GEMM and equals the CPU's (argmax, 1e-4 relative); the noisy
    one launches none."""
    xb, quiet = _example("crossbar_inference_torch")
    card = quiet(xb.main, ["--net", "alexnet", "--batch", "2"])
    cpu = quiet(xb.main, ["--net", "alexnet", "--batch", "2", "--device",
                          "cpu"])
    c = card["clean"]
    assert c["launches"] == c["gemms"] == 8
    assert card["noisy"]["launches"] == 0
    got, ref = c["logits"].cpu(), cpu["clean"]["logits"]
    assert (got.argmax(1) == ref.argmax(1)).all()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_serve_lm_example_on_the_card(cuda):
    """The example's loop in float32 on the card against the CPU: logits
    within 1e-4 of max |logit| and equal ids; no kernel launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    sv, _ = _example("serve_lm_torch")
    cfg = get_config("internlm2_1_8b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    kernels = COUNTED
    before = [k.launches for k in kernels]
    f32 = torch.float32
    got = sv.generate(cfg, _to(params, cuda), prompts.to(cuda), None, 8,
                      compute_dtype=f32)
    want = sv.generate(cfg, params, prompts, None, 8, compute_dtype=f32)
    assert [k.launches for k in kernels] == before
    gap = (got["logits"].cpu() - want["logits"]).abs().max()
    assert gap <= 1e-4 * want["logits"].abs().max()
    assert torch.equal(got["seqs"].cpu(), want["seqs"])


@pytest.mark.cuda
def test_train_lm_example_on_the_card(cuda, tmp_path, monkeypatch):
    """Two steps of a 2-layer reduced InternLM2 by default on the card,
    through one capture of the compiled step: finite losses, both steps
    saved, no kernel launch."""
    import dataclasses
    from repro_torch.configs import get_config
    tl, quiet = _example("train_lm_torch")
    monkeypatch.setattr(tl, "build_100m_config", lambda: dataclasses.replace(
        get_config("internlm2_1_8b").reduced(), n_layers=2))
    kernels = COUNTED
    before = [k.launches for k in kernels]
    r = quiet(tl.main, ["--steps", "2", "--batch", "2", "--seq", "32",
                        "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    assert [k.launches for k in kernels] == before
    assert r["device"].startswith("cuda") and len(r["losses"]) == 2
    assert r["captures"] == 1
    assert all(np.isfinite(r["losses"]))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1", "step_2"]


# ---------------------------------------------------------------------------
# quantize_layout: the executor's left operands
# ---------------------------------------------------------------------------

# name -> (input shape, quantize_layout kwargs besides K, K): the cases of
# tests/test_torch_quantize_layout.py (conv geometries at batch 1 and 3,
# a 1x1 stride-2 input whose largest |x| sits on an odd row, both
# layouts at 4/6/8-bit inputs, the fc flatten, tokens, attention's Q view
# and probabilities)
_QL_CONVS = [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0), (4, 4, 0),
             (5, 1, 2), (11, 4, 2)]
QL_CASES = {
    **{f"conv{k}s{s}p{p}-b{b}": ((b, 32, 32, 3), dict(conv=(k, s, p)),
                                 -(-3 * k * k // 494) * 494)
       for k, s, p in _QL_CONVS for b in (1, 3)},
    "odd-row-1x1s2": ((2, 32, 32, 4), dict(conv=(1, 2, 0)), 494),
    **{f"layout{rows}-adc{adc}-a{bits}": (
        (1, 32, 32, 64), dict(conv=(3, 1, 1), rows=rows, adc_bits=adc,
                              bits=bits), -(-576 // rows) * rows)
       for rows, adc in ((494, 9), (512, 9), (128, 5), (494, 8))
       for bits in (4, 6, 8)},
    "fc-flatten": ((3, 256), dict(rows=128, adc_bits=5), 256),
    "tokens": ((192, 192), dict(bits=4), 494),
    "qk-view": ((2, 16, 360), dict(rows=40, adc_bits=5, per_slice=True), 40),
    "pv": ((6, 40, 40), dict(rows=40, per_slice=True), 40),
    # a dynamic stage's right operand, read K-major as it lies in the
    # fused projection: the K heads (vit_tiny b16's), and V's transposed
    # heads, a stride of 3D along k, at 4 bits on the sliced branch
    "k-heads": ((16, 64, 576), dict(rows=64, per_slice=True), 64),
    "v-heads-w4": ((2, 64, 576), dict(rows=64, adc_bits=6, per_slice=True,
                                      bits=4), 64),
    # x / scale within an ulp of half-integers: where the kernel's
    # multiply by 1/scale is not enough and the true division decides
    "near-ties": ((64, 1000), dict(rows=494), 1482),
    "near-ties-conv": ((2, 16, 16, 8), dict(conv=(3, 1, 1)), 494),
    # the walks that decode each element's pixel: an input whose last row
    # and column no window reads (its largest |x| there), and a
    # non-contiguous one (the first 8 of 12 channels)
    "partly-covered-3s2p0": ((2, 32, 32, 8), dict(conv=(3, 2, 0)), 494),
    "channel-slice-3s1p1": ((2, 16, 16, 12), dict(conv=(3, 1, 1)), 494),
    # the covered input at ONE_LAUNCH_MAX elements (one launch) and one
    # image row over it (the multi-pass path): a 3x3 conv over 32
    # channels, and rows of 512 tokens
    "threshold-at-conv": ((1, 64, 32, 32), dict(conv=(3, 1, 1)), 494),
    "threshold-over-conv": ((1, 65, 32, 32), dict(conv=(3, 1, 1)), 494),
    "threshold-at-rows": ((128, 512), dict(rows=494), 988),
    "threshold-over-rows": ((129, 512), dict(rows=494), 988),
}
# QL_CASES whose operand has one amax: the requant factor is asked too
QL_STATIC = [c for c, (_, kw, _) in QL_CASES.items()
             if not kw.get("per_slice")]
# per-slice QL_CASES of a dynamic stage's left operand: the per-slice
# requant factor is asked, from a right operand's amax (one a slice)
QL_DYN_LEFT = ["qk-view", "pv"]


def near_ties(shape, g, device, bits=8, amax=3.0):
    """Values (k + 1/2) * scale for integers -qmax <= k < qmax, and one of
    |x| = ``amax`` (so that scale is ``quantize_scale(amax)``): each
    x / scale lies within an ulp or so of a half-integer."""
    from repro_torch.kernels.quantize_layout import qmax, quantize_scale
    s = quantize_scale(torch.tensor(amax), bits).item()
    k = torch.randint(-qmax(bits), qmax(bits), shape, generator=g,
                      device=device)
    x = ((k + 0.5) * s).float()
    x.view(-1)[0] = amax
    return x


def _ql_input(name, shape, g, device):
    if name.startswith("near-ties"):
        return near_ties(shape, g, device)
    x = torch.randn(shape, generator=g, device=device)
    if name.startswith("odd-row"):
        x[1, 5, 6, 2] = -40.0                   # no patch reads it
    if name.startswith("partly-covered"):
        x[1, 31, 4, 3] = 40.0                   # no patch reads it
        x[0, 6, 31, 5] = -40.0
    if name.startswith("channel-slice"):
        return x[..., :8]                       # strides of 12 channels
    from repro_torch.program.sequence import qkv_head_views
    if name == "qk-view":                       # the Q heads, permuted
        return qkv_head_views(x, 3)[0]
    if name == "k-heads":
        return qkv_head_views(x, 3)[1]
    if name.startswith("v-heads"):              # Vᵀ, K-major
        return qkv_head_views(x, 3)[2].mT
    return x


def _held_equal(got, want) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["auto", "one-launch", "multi-pass"])
@pytest.mark.parametrize("case", list(QL_CASES))
def test_quantize_layout_kernel_equals_plain(cuda, case, path, monkeypatch):
    """The kernel's (x8, amax) ``torch.equal`` to the plain version on the
    same card tensors, one launch a call, on each path the wrapper can
    take (forced through ``ONE_LAUNCH_MAX``: the one-launch clusters, or
    the amax partials then quantize, or image and gather; a 1x1 conv takes
    the multi-pass path whatever the limit); where the
    operand has one amax, the requant factor too (``w_amax`` below 1e-8
    for the conv geometries), and for a dynamic stage's left operand the
    per-slice factor from a ``w_amax`` a slice (some below 1e-8)."""
    from repro_torch.kernels.quantize_layout import plan
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    shape, kw, K = QL_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case))
    x = _ql_input(case, shape, g, cuda)
    if case in QL_STATIC:
        w_amax = torch.tensor(3e-9 if case.startswith("conv") else 2.75,
                              device=cuda)
        kw = dict(kw, w_amax=w_amax, weight_bits=4 if "a4" in case else 8)
    if case in QL_DYN_LEFT:
        slices = int(np.prod(x.shape[:-2]))
        w_amax = torch.rand(slices, generator=g, device=cuda) * 3
        w_amax[::4] = 5e-9
        kw = dict(kw, w_amax=w_amax, weight_bits=4)
    geo = {k: v for k, v in kw.items() if k in ("rows", "adc_bits", "conv",
                                                "per_slice")}
    if case.startswith("threshold"):       # sized to ONE_LAUNCH_MAX = 2^16
        assert qmod.ONE_LAUNCH_MAX == 1 << 16
        assert plan(x, K, **geo).one_launch == ("-at-" in case)
    if path != "auto":                     # a 1x1 conv: always multi-pass
        monkeypatch.setattr(qmod, "ONE_LAUNCH_MAX",
                            2 ** 31 if path == "one-launch" else -1)
        assert plan(x, K, **geo).one_launch == (
            path == "one-launch" and geo.get("conv", (3,))[0] > 1)
    before = quantize_layout.launches
    got = quantize_layout(x, K, **kw)
    assert quantize_layout.launches == before + 1
    want = quantize_layout_ref(x, K, **kw)
    torch.cuda.synchronize()
    _held_equal(got, want)
    assert len(got) == (3 if case in QL_STATIC + QL_DYN_LEFT else 2)
    if case.startswith(("odd-row", "partly-covered")):
        assert got[1] < 40.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["layout494-adc9-a8", "layout128-adc5-a4",
                                  "conv1s2p0-b3", "fc-flatten", "pv",
                                  "threshold-over-conv",
                                  "threshold-over-rows"])
def test_quantize_layout_replay_equals_eager(cuda, case):
    """One call captured in a CUDA graph (scratch, clusters and all) and
    replayed on a new input equals an eager call on that input, twice."""
    shape, kw, K = QL_CASES[case]
    if case in QL_STATIC:
        kw = dict(kw, w_amax=torch.tensor(1.5, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quantize_layout(x, K, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = quantize_layout(x, K, **kw)
    for scale in (0.5, 7.0):
        x.copy_(torch.randn(shape, generator=g, device=cuda) * scale)
        graph.replay()
        _held_equal(captured, quantize_layout(x, K, **kw))


@pytest.mark.cuda
def test_resnet18_runs_no_scalar_kernels_for_the_requant(cuda):
    """ResNet-18 at b16: eager ``execute_packed`` calls no PyTorch op for
    a stage's scale (no ``clamp_min``, ``mul``, ``maximum``: the kernel
    writes the requant factor), each ``quantize_layout`` call launches
    exactly ``device_kernels`` kernels of its own and nothing else (no
    memset), and a replay of ``run`` launches the eager forward's kernels
    and no others."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels.quantize_layout import device_kernels
    from repro_torch.program.execute import execute_packed

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    model = api.compile("resnet18", api.HurryConfig(), seed=0,
                        device="cuda")
    x = torch.randn(model.program.input_shape(16), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    with Ops() as ops:
        execute_packed(model.packed, x, return_logits=True)
    assert not {"clamp_min", "mul", "maximum"} & set(ops.names), ops.names
    execute = importlib.import_module("repro_torch.program.execute")
    calls = []
    real = execute.quantize_layout

    def spy(xin, K, **kw):
        calls.append((xin, K, kw))
        return real(xin, K, **kw)

    execute.quantize_layout = spy
    try:
        execute_packed(model.packed, x, return_logits=True)
    finally:
        execute.quantize_layout = real
    own = re.compile(r"\(anonymous namespace\)::(one_conv|one_rows|"
                     r"partials_conv|partials_rows|image|gather|"
                     r"quantize_rows)_kernel")
    for xin, K, kw in calls:
        quantize_layout(xin, K, **kw)          # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            quantize_layout(xin, K, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == device_kernels(xin, K, **kw)
        assert all(own.search(n) for n in names), names
    def kernels(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith("Memcpy"))

    # a replay launches what the eager forward launched, and no more (the
    # copies of the request in and the answer out aside)
    replay = kernels(lambda: model.run(x, logits=True))
    assert replay == kernels(lambda: execute_packed(model.packed, x,
                                                    return_logits=True))


def _spied_quantize_layout(monkeypatch):
    """Record every call of the executor's ``quantize_layout`` (inputs and
    outputs) and the devices that reach ``quantize_layout_ref``."""
    import importlib
    execute = importlib.import_module("repro_torch.program.execute")
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    calls, ref_devices = [], []
    real, real_ref = execute.quantize_layout, qmod.quantize_layout_ref

    def spy(x, K, **kw):
        out = real(x, K, **kw)
        calls.append((x, K, kw, out))
        return out

    def ref_spy(x, *args, **kw):
        ref_devices.append(x.device.type)
        return real_ref(x, *args, **kw)

    monkeypatch.setattr(execute, "quantize_layout", spy)
    monkeypatch.setattr(qmod, "quantize_layout_ref", ref_spy)
    return calls, ref_devices, real_ref


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["resnet18", "vit_tiny"])
def test_executor_left_operands_on_the_kernel(cuda, net, monkeypatch):
    """ResNet-18 and vit_tiny at batch 16, eager ``execute_packed``: one
    ``quantize_layout`` launch per static stage and two per dynamic stage
    (its right operand, then its left one, given the right one's amax),
    each call at the stage's full size ``torch.equal`` to the plain
    version (every requant factor too: the static stages', the dynamic
    stages' per-slice product), and no CUDA tensor reaches the plain
    version from the executor."""
    from repro_torch.program.execute import execute_packed
    model = api.compile(net, api.HurryConfig(), seed=0, device="cuda")
    x = torch.randn(model.program.input_shape(16), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(16))
    calls, ref_devices, real_ref = _spied_quantize_layout(monkeypatch)
    before = quantize_layout.launches
    execute_packed(model.packed, x, return_logits=True)
    torch.cuda.synchronize()
    n = len(model.program.stages())
    n_dyn = sum(g.kind == "dyn_gemm" for g, _ in model.program.stages())
    assert quantize_layout.launches == before + n + n_dyn
    assert len(calls) == n + n_dyn
    assert ref_devices == []
    assert sum("w_amax" in kw for _, _, kw, _ in calls) == n
    dyn = [c for c in calls if c[2].get("per_slice")]
    assert len(dyn) == 2 * n_dyn
    for (_, _, rkw, right), (_, _, lkw, left) in zip(dyn[0::2], dyn[1::2]):
        assert "w_amax" not in rkw and lkw["w_amax"] is right[1]
        assert left[2].shape == (left[1].numel(), 1, 1)
    for xin, K, kw, got in calls:
        _held_equal(got, real_ref(xin, K, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits", [9, 6])
def test_dyn_stages_on_the_card_equal_the_plain_versions(cuda, adc_bits,
                                                        monkeypatch):
    """vit_tiny b16's dynamic stages on the card, each of their four calls
    held against its plain version on the same card tensors: the two
    ``quantize_layout`` calls (``test_executor_left_operands_on_the_
    kernel``), ``crossbar_gemm`` on ``wt`` and K alone, and
    ``fb_epilogue`` with no bias, the context's heads merged on store;
    the stage's output is also the CPU path's stage output on the same
    buffers (int32 equal, so the context bit for bit, the probabilities
    to the softmax's 1e-6)."""
    execute = importlib.import_module("repro_torch.program.execute")
    cfg_kw = dict(adc_bits=adc_bits)
    if adc_bits == 6:
        cfg_kw.update(input_bits=4, weight_bits=4)     # sliced, 4-bit
    model = api.compile("vit_tiny", api.HurryConfig(**cfg_kw), seed=0,
                        device="cuda")
    cfg = model.program.cfg
    x = torch.randn(model.program.input_shape(16), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    seen, calls = [], []
    real = (execute._dyn_stage, execute.crossbar_gemm, execute.fb_epilogue)

    def stage(gemm, posts, bufs, cfg):
        seen.append((gemm, posts, dict(bufs)))
        return real[0](gemm, posts, bufs, cfg)

    monkeypatch.setattr(execute, "_dyn_stage", stage)
    execute.execute_packed(model.packed, x, return_logits=True)
    monkeypatch.setattr(execute, "_dyn_stage", real[0])

    def gemm(x8, w8=None, **kw):
        y = real[1](x8, w8, **kw)
        calls.append(("gemm", x8, kw, y))
        return y

    def fb(y, scale, bias, res=None, **kw):
        out = real[2](y, scale, bias, res, **kw)
        calls.append(("fb", (y, scale, bias), kw, out))
        return out

    monkeypatch.setattr(execute, "crossbar_gemm", gemm)
    monkeypatch.setattr(execute, "fb_epilogue", fb)
    assert len(seen) == 4
    for op, posts, bufs in seen:
        calls.clear()
        before = crossbar_gemm.launches, fb_epilogue.launches
        got = execute._dyn_stage(op, posts, bufs, cfg)
        assert (crossbar_gemm.launches, fb_epilogue.launches) == (
            before[0] + 1, before[1] + 1)
        (_, x8, gkw, y), (_, fargs, fkw, out) = calls
        assert gkw.get("K") and gkw["wt"].is_cuda
        # the plain version of the wt-only call: x8 against wt.mT in
        # chunks of up32(rows)
        r32 = -(-gkw["rows"] // 32) * 32
        want_y = (crossbar_gemm_exact_ref(x8, gkw["wt"].mT)
                  if not clip_possible(gkw["rows"], adc_bits)
                  else crossbar_gemm_ref(x8, gkw["wt"].mT,
                                         adc_bits=adc_bits, rows=r32))
        torch.cuda.synchronize()
        assert torch.equal(y, want_y)
        assert fargs[2] is None
        assert fkw.get("heads") == (op.heads if op.dyn == "pv" else 0)
        want = fb_epilogue_ref(*fargs, **fkw)
        torch.testing.assert_close(out, want, rtol=0,
                                   atol=1e-6 if fkw.get("softmax") else 0)
        cpu = real[0](op, posts, {k: v.cpu() for k, v in bufs.items()},
                      cfg)
        torch.testing.assert_close(got.cpu(), cpu, rtol=0,
                                   atol=1e-6 if op.dyn == "qk" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,heads", [(64, 3), (16, 3), (19, 2)])
@pytest.mark.parametrize("softmax", [False, True])
def test_fb_epilogue_heads_merged_on_store(cuda, N, heads, softmax):
    """The batched epilogue with no bias and ``heads``: one launch, its
    output (S / heads, M, heads * N) ``torch.equal`` to the same call with
    a zero bias and no heads, merged (the 16-byte path at N 64 and 16,
    the scalar one at 19; the warp-per-row path with the softmax), and to
    the plain version (the softmax to 1e-6)."""
    g = torch.Generator(device=cuda).manual_seed(N)
    S, M = 6 * heads, 40
    y = torch.randint(-2 ** 16, 2 ** 16, (S, M, N), generator=g,
                      device=cuda, dtype=torch.int32)
    scale = torch.rand(S, 1, 1, generator=g, device=cuda) * 1e-4
    kw = dict(softmax=softmax, post_scale=0.125 if softmax else 0.0)
    before = fb_epilogue.launches
    got = fb_epilogue(y, scale, None, heads=heads, **kw)
    assert fb_epilogue.launches == before + 1
    flat = fb_epilogue(y, scale, torch.zeros(N, device=cuda), **kw)
    assert got.shape == (S // heads, M, heads * N)
    assert torch.equal(got, flat.reshape(S // heads, heads, M, N)
                       .transpose(1, 2).reshape(S // heads, M, heads * N))
    torch.testing.assert_close(
        got, fb_epilogue_ref(y, scale, None, heads=heads, **kw), rtol=0,
        atol=1e-6 if softmax else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("adc_bits,rows,K", [(9, 64, 64), (5, 40, 80),
                                             (6, 64, 64)])
def test_crossbar_gemm_takes_wt_and_k_alone_on_the_card(cuda, adc_bits,
                                                        rows, K):
    """48 slices (vit_tiny b16's) with no (K, N) weight: x and ``wt`` in
    the kernel layout and K; one launch, ``torch.equal`` to the call with
    ``w`` and to the plain version."""
    rng = np.random.default_rng(K + adc_bits)
    S, M, N = 48, 64, 64
    x, w = _int8((S, M, K), rng).to(cuda), _int8((S, K, N), rng).to(cuda)
    x[:, :8] = -1
    w[:, :, :8] = -1
    wt = mount_weight(w, rows=rows, adc_bits=adc_bits)
    xk = kernel_layout(x, K, rows=rows, adc_bits=adc_bits).contiguous()
    before = crossbar_gemm.launches
    got = crossbar_gemm(xk, adc_bits=adc_bits, rows=rows, wt=wt, K=K)
    assert crossbar_gemm.launches == before + 1
    assert torch.equal(got, crossbar_gemm(x, w, adc_bits=adc_bits,
                                          rows=rows))
    torch.cuda.synchronize()
    assert torch.equal(got, crossbar_gemm_ref(x, w, adc_bits=adc_bits,
                                              rows=rows))
