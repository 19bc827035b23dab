"""``quantize_layout``'s plain version against the JAX package's chain.

On the card ``kernels.quantize_layout`` makes each stage's left operand in
one call of ``csrc/quantize_layout.cu``; its plain version,
``quantize_layout_ref``, follows the kernel's algorithm (an amax over the
covered elements, each element quantized once, gathered and scattered
into the layout).  Here it is held, on the same seeded numpy inputs,
against what the JAX executor computes under ``jax.jit``:
``repro.program.execute.im2col`` (or the flatten, the tokens, the
attention heads), ``repro.core.crossbar.quantize_symmetric`` (per slice
under ``jax.vmap`` for attention), the ``jnp.pad`` to full mounts, then
the port's ``kernel_layout``.  The int8 operand and the amax must be
equal, element for element.  The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 29).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.crossbar import quantize_scale as jax_quantize_scale
from repro.core.crossbar import quantize_symmetric as jax_quantize_symmetric
from repro.program.execute import im2col as jax_im2col
from repro.program.sequence import split_qkv_heads as jax_split_qkv_heads
from repro_torch.kernels import clip_possible, kernel_layout, quantize_layout
from repro_torch.kernels.quantize_layout import (conv_out, covered,
                                                 quantize_layout_ref,
                                                 quantize_scale)
from repro_torch.program.sequence import qkv_head_views

from test_torch_executable import IM2COL_CASES

# (rows, adc_bits): the exact layout (494 rows, the program's mount
# height at the default 9-bit ADC, no multiple of 32), and the sliced one
# (512 rows at 9 bits: one count can reach 512; 128 rows at 5 bits:
# chunks of whole 32-row groups; 494 at 8 bits: zero gaps of 18 columns
# between chunks)
LAYOUTS = {"exact-494": (494, 9), "sliced-512-adc9": (512, 9),
           "sliced-128-adc5": (128, 5), "sliced-494-adc8": (494, 8)}
ROWS = 494                       # the default config's mount height


def _full_mounts(kc: int, rows: int) -> int:
    """The mounts' K: ``kc`` padded to whole ``rows``-row mounts, as the
    packer pads a stage's weight."""
    return -(-kc // rows) * rows


def _jax_chain(xin: np.ndarray, K: int, bits: int, rows: int, adc: int,
               per_slice: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The JAX executor's quantize and pad, jitted (per slice under
    ``vmap``), then the port's kernel layout: (x8, amax)."""
    def one(a):
        q, _ = jax_quantize_symmetric(a, bits)
        q = q.astype(jnp.int8)
        return jnp.pad(q, ((0, 0), (0, K - q.shape[-1]))), jnp.max(
            jnp.abs(a))

    run = jax.jit(jax.vmap(one) if per_slice else one)
    x8, amax = (np.array(t) for t in run(jnp.asarray(xin)))
    laid = kernel_layout(torch.from_numpy(x8), K, rows=rows, adc_bits=adc)
    return laid.numpy(), amax


def _held(got, want) -> None:
    (x8, amax), (w8, wamax) = got, want
    assert x8.dtype == torch.int8 and amax.dtype == torch.float32
    np.testing.assert_array_equal(x8.numpy(), w8)
    np.testing.assert_array_equal(amax.numpy(), wamax)


def _image(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# conv patches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("k,stride,pad", IM2COL_CASES)
def test_conv_patches_equal_the_jax_chain(k, stride, pad, batch):
    x = _image((batch, 32, 32, 3), k * 100 + stride * 10 + batch)
    cols = np.asarray(jax_im2col(x, k, stride, pad))
    kc = cols.shape[-1]
    K = _full_mounts(kc, ROWS)
    want = _jax_chain(cols.reshape(-1, kc), K, 8, ROWS, 9)
    _held(quantize_layout_ref(torch.from_numpy(x), K, rows=ROWS,
                              conv=(k, stride, pad)), want)


def test_odd_row_maximum_under_a_1x1_stride_2_conv():
    """ResNet-18's projections (k 1, s 2, p 0) read only even rows and
    columns: the largest |x| on an odd row is not the operand's amax."""
    x = _image((2, 32, 32, 4), 12)
    x[1, 5, 6, 2] = -40.0                       # odd row, even column
    x[0, 8, 9, 1] = 35.0                        # even row, odd column
    cols = np.asarray(jax_im2col(x, 1, 2, 0)).reshape(-1, 4)
    want = _jax_chain(cols, ROWS, 8, ROWS, 9)
    got = quantize_layout_ref(torch.from_numpy(x), ROWS, rows=ROWS,
                              conv=(1, 2, 0))
    _held(got, want)
    assert got[1] < 35.0 < np.abs(x).max()      # the case discriminates


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_layouts_and_input_bits_equal_the_jax_chain(bits, layout):
    """A 3x3 stride-1 conv over 64 channels (576 columns: more than one
    chunk) at 4-, 6- and 8-bit inputs, on both layouts."""
    rows, adc = LAYOUTS[layout]
    x = _image((1, 32, 32, 64), bits)
    cols = np.asarray(jax_im2col(x, 3, 1, 1)).reshape(-1, 576)
    K = _full_mounts(576, rows)
    want = _jax_chain(cols, K, bits, rows, adc)
    got = quantize_layout_ref(torch.from_numpy(x), K, bits=bits, rows=rows,
                              adc_bits=adc, conv=(3, 1, 1))
    _held(got, want)
    assert clip_possible(rows, adc) == layout.startswith("sliced")
    assert got[0].shape[-1] == kernel_layout(
        torch.zeros(1, K, dtype=torch.int8), K, rows=rows,
        adc_bits=adc).shape[-1]


@pytest.mark.parametrize("k,stride,pad,n", [
    (1, 2, 0, 32), (1, 2, 0, 31), (3, 2, 1, 31), (5, 2, 0, 32), (2, 3, 1, 13),
    (11, 4, 2, 32), (3, 1, 1, 32)])
def test_covered_rows_are_those_a_window_reads(k, stride, pad, n):
    reads = {o * stride - pad + d for o in range(conv_out(n, k, stride, pad))
             for d in range(k)}
    got = [t for sl in covered(n, k, stride, pad)
           for t in range(n)[sl]]
    assert sorted(got) == sorted(reads & set(range(n)))
    assert len(got) == len(set(got))            # no row counted twice


# ---------------------------------------------------------------------------
# strided views: the fc flatten, tokens, attention's left operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["exact-494", "sliced-128-adc5"])
def test_fc_flatten_equals_the_jax_chain(layout):
    rows, adc = LAYOUTS[layout]
    x = _image((3, 4, 4, 16), 21)               # NHWC, flattened to 256
    xin = torch.from_numpy(x).reshape(3, -1)
    K = _full_mounts(256, rows)
    _held(quantize_layout_ref(xin, K, rows=rows, adc_bits=adc),
          _jax_chain(x.reshape(3, -1), K, 8, rows, adc))


@pytest.mark.parametrize("bits", [4, 8])
def test_token_stage_equals_the_jax_chain(bits):
    """A sequence stage's (B, T, D) tokens as (B*T, D) rows."""
    x = _image((3, 64, 192), 22)
    K = _full_mounts(192, ROWS)
    _held(quantize_layout_ref(torch.from_numpy(x).reshape(-1, 192), K,
                              bits=bits, rows=ROWS),
          _jax_chain(x.reshape(-1, 192), K, bits, ROWS, 9))


@pytest.mark.parametrize("layout", ["exact-494", "sliced-128-adc5"])
def test_qk_heads_view_per_slice_equals_the_jax_chain(layout):
    """Q·Kᵀ's left operand: the Q heads of a (B, T, 3D) projection, read
    as a permuted (B, heads, T, hd) view, one amax per (batch, head).
    The head dim 40 is the mount height: sliced at a 5-bit ADC, its
    chunk padded to 64 columns."""
    rows, adc = LAYOUTS[layout]
    B, T, D, heads = 2, 16, 120, 3
    qkv = _image((B, T, 3 * D), 23)
    q, _, _ = jax_split_qkv_heads(jnp.asarray(qkv), heads)   # (BH, T, hd)
    hd = D // heads
    rows = min(rows, hd)
    K = _full_mounts(hd, rows)
    want = _jax_chain(np.asarray(q), K, 8, rows, adc, per_slice=True)
    view, _, _ = qkv_head_views(torch.from_numpy(qkv), heads)
    assert not view.is_contiguous()             # read as it lies
    x8, amax = quantize_layout_ref(view, K, rows=rows, adc_bits=adc,
                                   per_slice=True)
    _held((x8.flatten(0, 1), amax.flatten()), want)
    assert clip_possible(rows, adc) == layout.startswith("sliced")


def test_pv_probabilities_per_slice_and_scale():
    """P·V's left operand, (BH, T, T) probabilities, one amax per slice;
    the scale formed from it equals the JAX package's."""
    p = np.random.default_rng(24).dirichlet(np.ones(40), (6, 40)).astype(
        np.float32)
    want = _jax_chain(p, 40, 8, 40, 9, per_slice=True)
    got = quantize_layout_ref(torch.from_numpy(p), 40, rows=40,
                              per_slice=True)
    _held(got, want)
    np.testing.assert_array_equal(
        quantize_scale(got[1]).numpy(),
        np.asarray(jax.jit(jax_quantize_scale)(jnp.asarray(want[1]))))


def test_wrapper_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(_image((2, 9, 9, 5), 25))
    before = quantize_layout.launches
    got = quantize_layout(x, 64, rows=20, adc_bits=4, conv=(3, 2, 1))
    want = quantize_layout_ref(x, 64, rows=20, adc_bits=4, conv=(3, 2, 1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert quantize_layout.launches == before
    with pytest.raises(TypeError):
        quantize_layout(x.double(), 64, conv=(3, 2, 1))
    with pytest.raises(ValueError):
        quantize_layout(x, 40, conv=(3, 2, 1))  # 45 columns exceed K
