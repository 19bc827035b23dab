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
from repro_torch.kernels import (clip_possible, crossbar_gemm,
                                 crossbar_gemm_exact_ref, crossbar_gemm_ref,
                                 fb_epilogue, fb_epilogue_ref,
                                 flash_attention, flash_attention_ref,
                                 fused_gemm_epilogue, fused_gemm_epilogue_ref,
                                 kernel_layout, mount_weight, ops,
                                 packed_gemm, packed_gemm_ref,
                                 packed_gemm_tiles_ref, pad_groups,
                                 tile_group_map)


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
