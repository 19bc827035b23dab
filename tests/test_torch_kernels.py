"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper computes its plain PyTorch version; it must equal
the Pallas kernel run in interpret mode (jitted, as the JAX package's own
tests run it): exactly for the crossbar GEMM and for the FB modes whose
roundings are the same, within a stated tolerance where a transcendental
or the order of a sum differs.  ``test_torch_cuda.py`` holds the CUDA
kernels against the same plain versions on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crossbar_gemm import crossbar_gemm as jax_crossbar_gemm
from repro.kernels.fb_epilogue import fb_epilogue as jax_fb_epilogue
from repro_torch.kernels import (clip_possible, crossbar_gemm,
                                 crossbar_gemm_exact_ref, crossbar_gemm_ref,
                                 fb_epilogue, kernel_layout, mount_weight)


def _int8_operands(M, K, N, seed=0, saturate=True):
    """Random int8 operands; a quarter of x's rows and w's columns are -1
    (every bit set) so that bitline counts reach ``rows`` and clip."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K), dtype=np.int8)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    if saturate:
        x[: M // 4] = -1
        w[:, : N // 4] = -1
    return x, w


@pytest.mark.parametrize("exact", [None, False])
@pytest.mark.parametrize("rows", [27, 255, 494])
@pytest.mark.parametrize("adc_bits", [8, 9])
def test_crossbar_gemm_plain_equals_pallas(adc_bits, rows, exact):
    x, w = _int8_operands(37, 1001, 19, seed=rows + adc_bits)
    ref = jax_crossbar_gemm(jnp.asarray(x), jnp.asarray(w),
                            adc_bits=adc_bits, rows=rows, block_m=16,
                            block_n=16, interpret=True, exact=exact)
    got = crossbar_gemm(torch.from_numpy(x), torch.from_numpy(w),
                        adc_bits=adc_bits, rows=rows, exact=exact)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_crossbar_gemm_sliced_clips_where_the_paper_array_does():
    """512 rows / 9-bit ADC: only all-ones bitlines clip, by one LSB."""
    x, w = _int8_operands(9, 1024, 7, seed=5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = crossbar_gemm(xt, wt, adc_bits=9, rows=512)
    ref = jax_crossbar_gemm(jnp.asarray(x), jnp.asarray(w), adc_bits=9,
                            rows=512, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert clip_possible(512, 9)
    assert not torch.equal(got, crossbar_gemm_exact_ref(xt, wt))


def test_crossbar_gemm_exact_true_raises_when_a_clip_can_fire():
    x, w = _int8_operands(4, 600, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="exact=True but ADC clipping"):
        crossbar_gemm(xt, wt, adc_bits=8, rows=494, exact=True)
    with pytest.raises(ValueError, match="exact=True but ADC clipping"):
        jax_crossbar_gemm(jnp.asarray(x), jnp.asarray(w), adc_bits=8,
                          rows=494, exact=True, interpret=True)
    # min(rows, K) decides: 600 > 255 rows clip, 200 rows of K=200 cannot
    crossbar_gemm(xt[:, :200], wt[:200], adc_bits=8, rows=494, exact=True)


def test_crossbar_gemm_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="int8"):
        crossbar_gemm(torch.zeros(2, 3), torch.zeros(3, 2))
    with pytest.raises(ValueError, match="do not multiply"):
        crossbar_gemm(torch.zeros(2, 3, dtype=torch.int8),
                      torch.zeros(4, 2, dtype=torch.int8))


def _np_kernel_layout(a, K, rows, exact):
    """numpy reference of the kernel layout: (R, k<=K) K-major -> (R, Kk),
    zero-padded to a multiple of 32 (exact) or chunk by chunk (sliced)."""
    up32 = lambda n: -(-n // 32) * 32                       # noqa: E731
    a = np.pad(a, ((0, 0), (0, K - a.shape[1])))
    if exact:
        return np.pad(a, ((0, 0), (0, up32(K) - K)))
    chunks = -(-K // rows)
    a = np.pad(a, ((0, 0), (0, chunks * rows - K)))
    a = a.reshape(a.shape[0], chunks, rows)
    return np.pad(a, ((0, 0), (0, 0), (0, up32(rows) - rows))).reshape(
        a.shape[0], -1)


@pytest.mark.parametrize("K", [27, 101, 988, 1458, 4860])
def test_kernel_layout_exact_operands_give_the_same_gemm(K):
    """x padded to K32 and the mounted wt (w transposed, K zero-padded to
    a multiple of 32): the plain GEMM on them equals the plain GEMM on
    the original operands, and the wrapper takes them on the CPU."""
    x, w = _int8_operands(16, K, 19, seed=K, saturate=False)
    xt, wt_ = torch.from_numpy(x), torch.from_numpy(w)
    wt = mount_weight(wt_, rows=511, adc_bits=9)
    xk = kernel_layout(xt, K, rows=511, adc_bits=9)
    assert wt.is_contiguous() and wt.shape == (19, -(-K // 32) * 32)
    assert xk.shape == (16, wt.shape[1])
    np.testing.assert_array_equal(wt.numpy(),
                                  _np_kernel_layout(w.T, K, 511, True))
    np.testing.assert_array_equal(xk.numpy(),
                                  _np_kernel_layout(x, K, 511, True))
    ref = crossbar_gemm_exact_ref(xt, wt_)
    assert torch.equal(crossbar_gemm_exact_ref(xk, wt.mT), ref)
    assert torch.equal(crossbar_gemm(xk, wt_, rows=511, wt=wt), ref)


@pytest.mark.parametrize("rows", [247, 486, 494, 511, 512])
def test_kernel_layout_chunk_padding_keeps_the_adc_semantics(rows):
    """The sliced branch's layout pads each rows-row chunk to a multiple of
    32 rows: the plain sliced GEMM on the padded operands with rows
    rounded up to 32 equals it on the original ones (the added rows are
    zeros, so every bitline count is the same), and both equal the
    Pallas kernel."""
    K = 1458
    x, w = _int8_operands(16, K, 19, seed=rows)
    xt, wt_ = torch.from_numpy(x), torch.from_numpy(w)
    kw = dict(rows=rows, adc_bits=8, exact=False)
    wt, xk = mount_weight(wt_, **kw), kernel_layout(xt, K, **kw)
    r32 = -(-rows // 32) * 32
    assert xk.shape[1] == -(-K // rows) * r32 == wt.shape[1]
    np.testing.assert_array_equal(xk.numpy(),
                                  _np_kernel_layout(x, K, rows, False))
    np.testing.assert_array_equal(wt.numpy(),
                                  _np_kernel_layout(w.T, K, rows, False))
    ref = crossbar_gemm_ref(xt, wt_, adc_bits=8, rows=rows)
    assert torch.equal(crossbar_gemm_ref(xk, wt.mT, adc_bits=8, rows=r32),
                       ref)
    assert torch.equal(crossbar_gemm(xk, wt_, wt=wt, **kw), ref)
    pallas = jax_crossbar_gemm(jnp.asarray(x), jnp.asarray(w), adc_bits=8,
                               rows=rows, block_m=16, block_n=16,
                               interpret=True, exact=False)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(pallas))


def test_kernel_layout_leaves_laid_out_operands_alone():
    """Nothing to pad (K a multiple of 32, rows a multiple of 32): the
    operand itself comes back, so a K-major mount costs no copy."""
    t = torch.zeros(3, 4, 512, dtype=torch.int8)
    assert kernel_layout(t, 512, rows=256, adc_bits=9) is t
    assert kernel_layout(t, 512, rows=256, adc_bits=8) is t


def test_crossbar_gemm_rejects_a_wt_of_another_layout():
    x, w = _int8_operands(4, 100, 3, saturate=False)
    xt, wt_ = torch.from_numpy(x), torch.from_numpy(w)
    sliced = mount_weight(wt_, rows=40, adc_bits=5)         # 3 x 64 rows
    with pytest.raises(ValueError, match="kernel layout"):
        crossbar_gemm(xt, wt_, rows=40, adc_bits=9, wt=sliced)
    with pytest.raises(ValueError, match="do not multiply"):
        crossbar_gemm(xt[:, :90], wt_, rows=40, adc_bits=5, wt=sliced)


@pytest.mark.parametrize("adc_bits,rows", [(9, 64), (5, 40)],
                         ids=["exact", "sliced"])
def test_crossbar_gemm_takes_wt_and_k_alone(adc_bits, rows):
    """A batched call with no (K, N) weight: ``wt`` (the right operand
    mounted straight into the kernel layout, as a dynamic stage's is) and
    the contraction length K, x in the kernel layout too, equals the call
    with ``w`` and the Pallas kernel vmapped over the slices; without K
    (or wt) it raises."""
    rng = np.random.default_rng(rows)
    S, M, K, N = 3, 16, 2 * rows, 24
    x = rng.integers(-128, 128, (S, M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (S, K, N)).astype(np.int8)
    xt, w8 = torch.from_numpy(x), torch.from_numpy(w)
    wt = mount_weight(w8, rows=rows, adc_bits=adc_bits)
    xk = kernel_layout(xt, K, rows=rows, adc_bits=adc_bits).contiguous()
    got = crossbar_gemm(xk, adc_bits=adc_bits, rows=rows, wt=wt, K=K)
    assert torch.equal(got, crossbar_gemm(xt, w8, adc_bits=adc_bits,
                                          rows=rows))
    ref = np.stack([np.asarray(jax_crossbar_gemm(
        jnp.asarray(x[i]), jnp.asarray(w[i]), adc_bits=adc_bits, rows=rows,
        interpret=True)) for i in range(S)])
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="wt and K"):
        crossbar_gemm(xk, adc_bits=adc_bits, rows=rows, wt=wt)
    with pytest.raises(ValueError, match="do not multiply"):
        crossbar_gemm(xt[..., :K - 1], adc_bits=adc_bits, rows=rows, wt=wt,
                      K=K)


# (kwargs, residual?, atol, reason) — atol 0 is bit for bit
FB_CASES = {
    "none": (dict(), False, 0.0, "same roundings"),
    "relu": (dict(act="relu"), False, 0.0, "same roundings"),
    "relu+residual": (dict(act="relu"), True, 0.0, "same roundings"),
    "post_scale": (dict(post_scale=0.125), False, 0.0, "same roundings"),
    "maxpool": (dict(act="relu", pool="max", window=2, img_hw=8), True, 0.0,
                "max is exact"),
    "avgpool": (dict(act="relu", pool="avg", window=4, img_hw=8), True, 1e-6,
                "XLA sums a 4x4 window in another order (2x2: same)"),
    "avgpool2": (dict(act="relu", pool="avg", window=2, img_hw=8), True,
                 0.0, "row-major window sum, as XLA's"),
    "gelu": (dict(act="gelu"), False, 2e-6, "XLA's tanh vs torch.tanh"),
    "layer": (dict(norm="layer"), True, 2e-6, "order of the row sums"),
    "seqmean": (dict(act="gelu", norm="layer", pool="seqmean", window=16),
                True, 2e-6, "order of the row and token sums, tanh"),
    "softmax": (dict(softmax=True), False, 2e-7, "XLA's exp, row sum order"),
}


def _fb_inputs(M, N, with_res, norm, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(-2 ** 20, 2 ** 20, (M, N), dtype=np.int32)
    scale = np.array([[3.1e-6]], np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32) if with_res \
        else None
    gb = ({"gamma": rng.standard_normal(N).astype(np.float32),
           "beta": rng.standard_normal(N).astype(np.float32)} if norm
          else {})
    return y, scale, bias, res, gb


@pytest.mark.parametrize("mode", list(FB_CASES))
def test_fb_epilogue_plain_matches_pallas(mode):
    kw, with_res, atol, _why = FB_CASES[mode]
    M, N = 2 * 64, 48
    y, scale, bias, res, gb = _fb_inputs(M, N, with_res, "norm" in kw)
    ref = jax_fb_epilogue(
        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias),
        None if res is None else jnp.asarray(res), interpret=True,
        **{k: jnp.asarray(v) for k, v in gb.items()}, **kw)
    got = fb_epilogue(
        torch.from_numpy(y), torch.from_numpy(scale), torch.from_numpy(bias),
        None if res is None else torch.from_numpy(res),
        **{k: torch.from_numpy(v) for k, v in gb.items()}, **kw)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if atol == 0.0:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


def test_fb_epilogue_dequant_is_one_fused_rounding():
    """y*scale + bias rounds once, as XLA's contracted FMA does: the
    unfused two-rounding form differs from the Pallas kernel somewhere."""
    y, scale, bias, _, _ = _fb_inputs(256, 64, False, False, seed=3)
    ref = np.asarray(jax_fb_epilogue(jnp.asarray(y), jnp.asarray(scale),
                                     jnp.asarray(bias), interpret=True))
    got = fb_epilogue(torch.from_numpy(y), torch.from_numpy(scale),
                      torch.from_numpy(bias)).numpy()
    unfused = (y.astype(np.float32) * scale[0, 0]) + bias
    np.testing.assert_array_equal(got, ref)
    assert (unfused != ref).any()


@pytest.mark.parametrize("mode", ["none", "post_scale", "softmax"])
@pytest.mark.parametrize("heads", [0, 3])
def test_fb_epilogue_heads_merged_and_no_bias_equal_pallas(heads, mode):
    """A dynamic stage's batched epilogue: (S, M, N) with a (S, 1, 1)
    scale, no bias (the JAX executor passes zeros), and with ``heads``
    the slices stored head-merged, (S / heads, M, heads * N): the Pallas
    kernel vmapped over the slices with a zero bias, then the JAX
    package's ``merge_heads``.  Bit for bit (the softmax to its
    ``FB_CASES`` tolerance)."""
    import jax
    from repro.program.sequence import merge_heads as jax_merge_heads
    kw, _, atol, _why = FB_CASES[mode]
    S, M, N = 6, 16, 24
    rng = np.random.default_rng(heads)
    y = rng.integers(-2 ** 20, 2 ** 20, (S, M, N), dtype=np.int32)
    scale = rng.uniform(1e-7, 1e-5, (S, 1, 1)).astype(np.float32)
    run = jax.vmap(lambda y2, s2: jax_fb_epilogue(
        y2, s2.reshape(1, 1), jnp.zeros(N, jnp.float32), None,
        interpret=True, **kw))
    ref = run(jnp.asarray(y), jnp.asarray(scale))
    ref = np.asarray(jax_merge_heads(ref, heads) if heads else ref)
    got = fb_epilogue(torch.from_numpy(y), torch.from_numpy(scale), None,
                      heads=heads, **kw).numpy()
    assert got.shape == ref.shape == ((S // heads, M, heads * N) if heads
                                      else (S, M, N))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    zeros = fb_epilogue(torch.from_numpy(y), torch.from_numpy(scale),
                        torch.zeros(N), heads=heads, **kw)
    assert torch.equal(torch.from_numpy(got), zeros)


def test_fb_epilogue_rejects_bad_modes():
    y = torch.zeros(16, 4, dtype=torch.int32)
    s, b = torch.ones(1, 1), torch.zeros(4)
    with pytest.raises(ValueError, match="never chain"):
        fb_epilogue(y, s, b, pool="max", window=2, img_hw=4, softmax=True)
    with pytest.raises(ValueError, match="gamma and beta"):
        fb_epilogue(y, s, b, norm="layer")
    with pytest.raises(ValueError, match="act"):
        fb_epilogue(y, s, b, act="tanh")
    y3 = torch.zeros(6, 16, 4, dtype=torch.int32)
    s3 = torch.ones(6, 1, 1)
    with pytest.raises(ValueError, match="heads"):
        fb_epilogue(y3, s3, None, heads=4)      # 6 slices
    with pytest.raises(ValueError, match="heads"):
        fb_epilogue(y3, s3, None, heads=3, pool="max", window=2, img_hw=4)
    with pytest.raises(ValueError, match="heads"):
        fb_epilogue(y, s, None, heads=1)        # no slice axis
