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
the port's ``kernel_layout``; for a dynamic stage's right operand,
``jax.vmap(plane_pack)`` laid out the same way.  The int8 operand and
the amax must be equal, element for element; a static stage's requant
factor equal to the jitted product ``quantize_symmetric(xin)[1] *
quantize_scale(w_amax)``, a dynamic stage's per-slice factor to the
vmapped ``ascale * ws``.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 29); here also the
path it takes (``plan``), from the geometry alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.crossbar import quantize_scale as jax_quantize_scale
from repro.core.crossbar import quantize_symmetric as jax_quantize_symmetric
from repro.program.execute import im2col as jax_im2col
from repro.program.pack import plane_pack as jax_plane_pack
from repro.program.sequence import split_qkv_heads as jax_split_qkv_heads
from repro_torch import api as tapi
from repro_torch import trace
from repro_torch.core.crossbar import dequant_scale
from repro_torch.kernels import (clip_possible, kernel_layout, mount_weight,
                                 quantize_layout)
from repro_torch.kernels.crossbar_gemm import call_layout
from repro_torch.kernels.quantize_layout import (ONE_LAUNCH_MAX, conv_out,
                                                 covered, device_kernels,
                                                 plan, quantize_layout_ref,
                                                 quantize_scale)
from repro_torch.program.sequence import qkv_head_views

from test_torch_cuda import WIDTHS
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
    before = trace.counters().get("launches.quantize_layout", 0)
    got = quantize_layout(x, 64, rows=20, adc_bits=4, conv=(3, 2, 1))
    want = quantize_layout_ref(x, 64, rows=20, adc_bits=4, conv=(3, 2, 1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trace.counters().get("launches.quantize_layout", 0) == before
    with pytest.raises(TypeError):
        quantize_layout(x.double(), 64, conv=(3, 2, 1))
    with pytest.raises(ValueError):
        quantize_layout(x, 40, conv=(3, 2, 1))  # 45 columns exceed K


# ---------------------------------------------------------------------------
# a dynamic stage's right operand and its per-slice requant factor
# ---------------------------------------------------------------------------

# the vit configurations of tests/test_torch_sequence.py's teacher-forced
# test: (vit_tiny_graph kwargs, HurryConfig kwargs)
VIT_CONFIGS = {
    "small": (dict(depth=1, dim=48, heads=3), dict()),
    "small-adc5": (dict(depth=1, dim=48, heads=3), dict(adc_bits=5)),
    "full-width": (dict(), dict()),
    "full-width-w4a4-adc6": (dict(), WIDTHS["w4a4_adc6"]),
}


def _dyn_stages(config):
    """A compiled vit_tiny's dynamic stages (CPU), its config and its
    model dim (64 tokens at the default patch and input size)."""
    graph_kw, cfg_kw = VIT_CONFIGS[config]
    model = tapi.compile(tapi.vit_tiny_graph(**graph_kw),
                         tapi.HurryConfig(**cfg_kw), seed=0, device="cpu")
    return ([g for g, _ in model.program.stages() if g.kind == "dyn_gemm"],
            model.program.cfg, graph_kw.get("dim", 192))


@pytest.mark.parametrize("dyn", ["qk", "pv"])
@pytest.mark.parametrize("config", list(VIT_CONFIGS))
def test_right_operand_equals_the_jax_plane_pack(config, dyn):
    """The right operand mounted by ``quantize_layout`` on its K-major
    view as it lies in a (B, T, 3D) fused projection (Q·Kᵀ: the K heads,
    (B, H, T, hd); P·V: V's transposed heads, (B, H, hd, T), a stride of
    3D along k) at ``weight_bits``, per slice: the planes and amaxes of
    the JAX package's jitted ``jax.vmap(plane_pack)`` over (BH, K, N),
    laid out by ``kernel_layout`` (``mount_weight``), element for
    element."""
    gemms, cfg, dim = _dyn_stages(config)
    gemm = next(g for g in gemms if g.dyn == dyn)
    qkv = _image((2, 64, 3 * dim), 31 + len(config))
    _, k, v = jax_split_qkv_heads(jnp.asarray(qkv), gemm.heads)
    w = jnp.swapaxes(k, 1, 2) if dyn == "qk" else v       # (BH, K, N)
    rows = min(gemm.tile_rows, w.shape[1])
    run = jax.jit(jax.vmap(lambda w2: jax_plane_pack(
        w2, tile_rows=rows, weight_bits=cfg.weight_bits)))
    jw8, jamax = (np.array(t) for t in run(w))
    K = jw8.shape[1]
    _, kv, vv = qkv_head_views(torch.from_numpy(qkv), gemm.heads)
    view = kv if dyn == "qk" else vv.mT
    assert not view.is_contiguous()             # read as it lies
    if dyn == "pv":
        assert view.stride(-1) == 3 * dim
    wt, amax = quantize_layout_ref(view, K, bits=cfg.weight_bits, rows=rows,
                                   adc_bits=cfg.adc_bits, per_slice=True)
    want = mount_weight(torch.from_numpy(jw8), rows=rows,
                        adc_bits=cfg.adc_bits)
    _held((wt.flatten(0, 1), amax.flatten()), (want.numpy(), jamax))


@pytest.mark.parametrize("amaxes", ["plain", "a-below-floor",
                                    "w-below-floor"])
@pytest.mark.parametrize("weight_bits", [4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_per_slice_requant_equals_the_vmapped_product(bits, weight_bits,
                                                      amaxes):
    """A dynamic stage's two calls, the right operand first: the left
    call's third output, given the right call's per-slice amax as
    ``w_amax``, equals the JAX executor's ``ascale * quantize_scale(
    wamax)`` under ``jax.jit(jax.vmap(...))``, (S, 1, 1) float32, bit for
    bit, on slices of magnitudes over three decades and with either amax
    below the 1e-8 floor; and it differs from ``dequant_scale``'s
    reassociated form on some slices."""
    rng = np.random.default_rng(bits * 10 + weight_bits)
    S, M, k, N = 300, 8, 16, 8
    mag = rng.uniform(0.01, 10, (S, 1, 1)).astype(np.float32)
    a = rng.standard_normal((S, M, k)).astype(np.float32) * mag
    w = rng.standard_normal((S, k, N)).astype(np.float32) * mag[::-1]
    if amaxes == "a-below-floor":
        a[::7] *= np.float32(1e-10)
    elif amaxes == "w-below-floor":
        w[::5] *= np.float32(1e-10)

    @jax.jit
    def jax_scale(a, w):
        def one(a2, w2):
            _, ascale = jax_quantize_symmetric(a2, bits)
            _, wamax = jax_plane_pack(w2, tile_rows=k,
                                      weight_bits=weight_bits)
            return (ascale * jax_quantize_scale(wamax, weight_bits)).astype(
                jnp.float32).reshape(1, 1)
        return jax.vmap(one)(a, w)

    want = np.asarray(jax_scale(a, w))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    _, w_amax = quantize_layout_ref(tw.mT, k, bits=weight_bits, rows=k,
                                    per_slice=True)
    got = quantize_layout_ref(ta, k, bits=bits, rows=k, per_slice=True,
                              w_amax=w_amax, weight_bits=weight_bits)
    assert len(got) == 3 and got[2].shape == (S, 1, 1)
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), want)
    assert (dequant_scale(got[1], w_amax, bits, weight_bits).numpy()
            != want.ravel()).any()
    wrapped = quantize_layout(ta, k, bits=bits, rows=k, per_slice=True,
                              w_amax=w_amax, weight_bits=weight_bits)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, got))


# ---------------------------------------------------------------------------
# the requant factor of a static stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amaxes", ["plain", "x-below-floor",
                                    "w-below-floor"])
@pytest.mark.parametrize("weight_bits", [4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_requant_equals_the_jitted_static_stage_product(bits, weight_bits,
                                                        amaxes):
    """``quantize_layout_ref(..., w_amax=)``'s third output against the
    JAX executor's static stage under ``jax.jit``: ``quantize_symmetric
    (xin, input_bits)[1] * quantize_scale(w_amax, weight_bits)`` as
    (1, 1) float32, bit for bit; an amax below the 1e-8 floor on either
    side too.  It is also ``dequant_scale``, which the executor called
    before the kernel wrote the factor."""
    rng = np.random.default_rng(bits * 10 + weight_bits)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w_amax = np.float32(rng.uniform(0.05, 3.0))
    if amaxes == "x-below-floor":
        x *= np.float32(1e-10)
    elif amaxes == "w-below-floor":
        w_amax = np.float32(4e-9)
    cols = np.asarray(jax_im2col(x, 3, 1, 1)).reshape(-1, 54)

    @jax.jit
    def static(xin, wa):
        _, xs = jax_quantize_symmetric(xin, bits)
        return (xs * jax_quantize_scale(wa, weight_bits)).astype(
            jnp.float32).reshape(1, 1)

    want = np.asarray(static(jnp.asarray(cols), jnp.asarray(w_amax)))
    got = quantize_layout_ref(torch.from_numpy(x), ROWS, bits=bits,
                              conv=(3, 1, 1),
                              w_amax=torch.tensor(w_amax),
                              weight_bits=weight_bits)
    assert len(got) == 3 and got[2].shape == (1, 1)
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[2].numpy(), want)
    np.testing.assert_array_equal(
        got[2].numpy(),
        dequant_scale(got[1], torch.tensor(w_amax), bits,
                      weight_bits).reshape(1, 1).numpy())
    _held(got[:2], _jax_chain(cols, ROWS, bits, ROWS, 9))


def test_requant_is_a_static_stages_only():
    """One ``w_amax`` a call, or per slice one a slice (a dynamic stage's
    left operand); nothing else."""
    x = torch.from_numpy(_image((6, 40, 40), 26))
    with pytest.raises(ValueError):
        quantize_layout(x, 40, rows=40, per_slice=True,
                        w_amax=torch.tensor(1.0))
    with pytest.raises(ValueError):
        quantize_layout(x[None].expand(2, -1, -1, -1), 40, rows=40,
                        conv=(1, 1, 0), per_slice=True, w_amax=torch.ones(1))
    assert quantize_layout(x, 40, rows=40, per_slice=True,
                           w_amax=torch.ones(6))[2].shape == (6, 1, 1)
    with pytest.raises(ValueError):
        quantize_layout(x[0], 40, rows=40, w_amax=torch.ones(2))
    assert len(quantize_layout(x[0], 40, rows=40)) == 2


@pytest.mark.parametrize("net", ["resnet18", "vit_tiny"])
def test_executor_takes_the_requant_factor_from_the_kernel(net,
                                                           monkeypatch):
    """``_static_stage`` passes its mount's ``w_amax`` and calls no
    ``dequant_scale``, and the forward still equals the one with
    ``dequant_scale``'s factor; ``dyn_mounts`` makes two calls a dynamic
    stage, the right operand at ``weight_bits`` first, then the left one
    with that call's per-slice amax as ``w_amax``, whose factor is the
    plain product of the two scales."""
    import importlib
    from repro_torch import api
    from repro_torch.program.execute import execute_packed
    execute = importlib.import_module("repro_torch.program.execute")
    crossbar = importlib.import_module("repro_torch.core.crossbar")
    assert not hasattr(execute, "dequant_scale")
    model = api.compile(net, api.HurryConfig(), seed=0, device="cpu")
    x = torch.from_numpy(_image(model.program.input_shape(2), 27))
    calls, requants = [], []
    real = execute.quantize_layout

    def spy(xin, K, **kw):
        out = real(xin, K, **kw)
        calls.append((kw, out))
        if "w_amax" in kw and not kw.get("per_slice"):
            # the factor dequant_scale would give
            requants.append(dequant_scale(out[1], kw["w_amax"],
                                          kw["bits"],
                                          kw["weight_bits"]).reshape(1, 1))
        return out

    def no_dequant(*args, **kw):
        raise AssertionError("the executor called dequant_scale")

    monkeypatch.setattr(execute, "quantize_layout", spy)
    monkeypatch.setattr(crossbar, "dequant_scale", no_dequant)
    execute_packed(model.packed, x, return_logits=True)
    stages = model.program.stages()
    static = [st for (g, _), st in zip(stages, model.packed.stages)
              if g.kind != "dyn_gemm"]
    n_dyn = sum(g.kind == "dyn_gemm" for g, _ in stages)
    dyn = [(kw, out) for kw, out in calls if kw.get("per_slice")]
    assert len(calls) == len(stages) + n_dyn
    assert len(dyn) == 2 * n_dyn
    assert (len(dyn) > 0) == (net == "vit_tiny")
    cfg = model.program.cfg
    for (rkw, right), (lkw, left) in zip(dyn[0::2], dyn[1::2]):
        assert "w_amax" not in rkw and rkw["bits"] == cfg.weight_bits
        assert lkw["w_amax"] is right[1] and lkw["bits"] == cfg.input_bits
        assert len(left) == 3 and torch.equal(left[2], (
            quantize_scale(left[1], cfg.input_bits)
            * quantize_scale(right[1].reshape(left[1].shape),
                             cfg.weight_bits)).reshape(-1, 1, 1))
    stat = [(kw, out) for kw, out in calls if not kw.get("per_slice")]
    assert [kw["w_amax"] for kw, _ in stat] == [st.w_amax for st in static]
    for (kw, out), want in zip(stat, requants):
        assert len(out) == 3 and torch.equal(out[2], want)


# ---------------------------------------------------------------------------
# the kernel's path, from the geometry
# ---------------------------------------------------------------------------

# (input shape, kwargs besides K, K, one launch?, device kernels)
PLAN_CASES = {
    "conv3x3-at-max": ((1, 64, 32, 32), dict(conv=(3, 1, 1)), 494, True, 1),
    "conv3x3-over-max": ((1, 65, 32, 32), dict(conv=(3, 1, 1)), 494, False,
                         3),
    "resnet-s0-b16": ((16, 32, 32, 64), dict(conv=(3, 1, 1), rows=494),
                      988, False, 3),
    "resnet-s0-b1": ((1, 32, 32, 64), dict(conv=(3, 1, 1), rows=494),
                     988, True, 1),
    # a 1x1 stride-2 projection reads a quarter of its input, rows of
    # strided pixels: the multi-pass path at every size
    "proj-1x1s2-b1": ((1, 32, 32, 64), dict(conv=(1, 2, 0), rows=64), 64,
                      False, 2),
    "proj-1x1s2-b16": ((16, 32, 32, 64), dict(conv=(1, 2, 0), rows=64), 64,
                       False, 2),
    "rows-at-max": ((128, 512), dict(rows=494), 988, True, 1),
    "rows-over-max": ((129, 512), dict(rows=494), 988, False, 2),
    "per-slice-small": ((48, 64, 64), dict(rows=64, per_slice=True), 64,
                        True, 1),
    "per-slice-large": ((4, 512, 512), dict(rows=494, per_slice=True), 988,
                        False, 2),
    "empty": ((0, 512), dict(rows=494), 988, True, 0),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_picks_the_path_from_the_geometry(case):
    """One launch where the covered input (a slice's, per slice) holds at
    most ``ONE_LAUNCH_MAX`` elements and the call is no 1x1 conv;
    otherwise the amax partials and one quantize pass, or, for a conv
    with k > 1, the image and the gather:
    ``device_kernels`` says 1, 2 or 3 (0 for an empty operand).  Scratch
    and cluster shapes stay within the kernel's limits."""
    shape, kw, K, one, kernels = PLAN_CASES[case]
    x = torch.zeros(shape)
    assert ONE_LAUNCH_MAX == 1 << 16            # the cases' sizes
    assert device_kernels(x, K, bits=4, **kw) == kernels
    if not kernels:
        return
    pl = plan(x, K, **kw)
    assert pl.one_launch == one and pl.kernels == kernels
    assert pl.image == (kernels == 3)
    assert 1 <= pl.cluster <= 8 and pl.cluster & (pl.cluster - 1) == 0
    slices = shape[0] if kw.get("per_slice") else 1
    if one:
        assert pl.blocks == slices if kw.get("per_slice") else \
            1 <= pl.blocks * pl.cluster <= 128
    else:
        assert 1 <= pl.blocks * slices <= 1024


# (input shape, kwargs besides K, K, device kernels given the partial
# maxima): calls with one amax over every element of x on the multi-pass
# path, rows and convs whose windows read every pixel
GIVEN_CASES = {
    "rows-over-max": ((129, 512), dict(rows=494), 988, 1),
    "tokens-3d": ((4, 196, 384), dict(rows=494), 494, 1),
    "conv3x3-over-max": ((1, 65, 32, 32), dict(conv=(3, 1, 1)), 494, 2),
    "resnet-s1b0-conv1": ((16, 32, 32, 64), dict(conv=(3, 2, 1), rows=494),
                          988, 2),
    "conv1x1-stride1": ((16, 32, 32, 64), dict(conv=(1, 1, 0), rows=64),
                        64, 1),
    "sliced": ((129, 512), dict(rows=128, adc_bits=5), 512, 1),
}
# calls that reduce their own amax whatever they are given
REFUSED_CASES = {
    "rows-at-max": ((128, 512), dict(rows=494), 988),         # one launch
    "conv3x3-at-max": ((1, 64, 32, 32), dict(conv=(3, 1, 1)), 494),
    "per-slice": ((4, 512, 512), dict(rows=494, per_slice=True), 988),
    "proj-1x1s2": ((16, 32, 32, 64), dict(conv=(1, 2, 0), rows=64), 64),
    "partly-covered-3s2p0": ((16, 32, 32, 8), dict(conv=(3, 2, 0)), 494),
}


@pytest.mark.parametrize("case", list(GIVEN_CASES))
def test_plan_with_given_partial_maxima(case):
    """Given the partial maxima of x's writer, a call launches no amax
    pass: ``plan`` and ``device_kernels`` say 1 kernel (rows) or 2 (the
    image and the gather), ``amax_pass_bytes`` none, where without them
    the pass reads every element of x as float32; the CPU path reduces
    its own amax, so what it returns does not depend on them."""
    from repro_torch.kernels.quantize_layout import (amax_pass_bytes,
                                                     takes_partials)
    shape, kw, K, kernels = GIVEN_CASES[case]
    x = torch.from_numpy(_image(shape, 31))
    parts = torch.full((7,), 0.25)           # their maximum is no amax here
    assert takes_partials(x.shape, kw.get("conv"))
    pl = plan(x, K, partials=7, **kw)
    assert (pl.one_launch, pl.kernels, pl.blocks) == (False, kernels, 7)
    assert pl.image == (kernels == 2)
    assert device_kernels(x, K, partials=parts, **kw) == kernels
    assert device_kernels(x, K, **kw) == kernels + 1
    assert amax_pass_bytes(x, K, partials=parts, **kw) == 0
    assert amax_pass_bytes(x, K, **kw) == 4 * x.numel()
    got = quantize_layout(x, K, partials=parts, **kw)
    for a, b in zip(got, quantize_layout(x, K, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(REFUSED_CASES))
def test_calls_that_reduce_their_own_amax_refuse_partial_maxima(case):
    """A call with one launch, an amax a slice or pixels no window
    reads takes no partial maxima: ``takes_partials`` is false and a call
    given them raises; so does a bad partials tensor or a strided x."""
    from repro_torch.kernels.quantize_layout import takes_partials
    shape, kw, K = REFUSED_CASES[case]
    x = torch.zeros(shape)
    assert not takes_partials(x.shape, kw.get("conv"),
                              kw.get("per_slice", False))
    with pytest.raises(ValueError):
        quantize_layout(x, K, partials=torch.ones(4), **kw)
    with pytest.raises(ValueError):
        plan(x, K, partials=4, **kw)
    x, K = torch.zeros(129, 512), 988
    for bad in (torch.ones(4, dtype=torch.float64), torch.ones(2, 2),
                torch.ones(4097), torch.ones(0)):
        with pytest.raises(ValueError):
            quantize_layout(x, K, partials=bad)
    with pytest.raises(ValueError):
        quantize_layout(torch.zeros(129, 1024)[:, :512], K,
                        partials=torch.ones(4))


def test_c_entries_take_what_the_wrapper_passes(monkeypatch):
    """Each C entry's parameters in ``csrc/quantize_layout.cu`` match
    ``SIGNATURES`` (``void*`` a pointer, ``int``, ``float``), and the
    wrapper passes each entry exactly that many arguments, each one
    ctypes converts, on every path (a stand-in library records them)."""
    import ctypes
    import importlib
    import re
    from pathlib import Path
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    src = (Path(qmod.__file__).parent / "csrc" /
           "quantize_layout.cu").read_text()
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    for name, argtypes in qmod.SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        types = [re.sub(r"\s+", "", p.rsplit(" ", 1)[0]).replace("const", "")
                 for p in params.split(",")]
        assert [kinds[t] for t in types] == argtypes, name

    calls = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            types = qmod.SIGNATURES[self.name]
            assert len(args) == len(types), (self.name, len(args))
            for t, a in zip(types, args):
                t.from_param(a)
            calls.append(self.name)
            return 0

    class Lib:
        quantize_layout_conv = Entry("quantize_layout_conv")
        quantize_layout_strided = Entry("quantize_layout_strided")

    monkeypatch.setattr(qmod, "_lib", lambda: Lib())
    monkeypatch.setattr(qmod._build, "stream_handle",
                        lambda: ctypes.c_void_p(0))
    # (shape, kwargs, K, w_amax): a static stage's one, a dynamic stage's
    # left operand's one a slice, or none (its right operand)
    cases = [((2, 9, 9, 8), dict(conv=(3, 1, 1)), 494, torch.tensor(1.0)),
             ((2, 9, 9, 8), dict(conv=(1, 2, 0)), 494, torch.tensor(1.0)),
             ((3, 256), dict(rows=128, adc_bits=5), 256, torch.tensor(1.0)),
             ((6, 40, 40), dict(rows=40, per_slice=True), 40, None),
             ((2, 3, 40, 40), dict(rows=40, per_slice=True), 40,
              torch.ones(2, 3))]
    for limit in (2 ** 31, -1):                 # one launch, multi-pass
        monkeypatch.setattr(qmod, "ONE_LAUNCH_MAX", limit)
        for shape, kw, K, w_amax in cases:
            x = torch.zeros(shape)
            kc, lead = qmod._geometry(x, K, kw.get("conv"))
            lay = call_layout(K, kw.get("rows", 512), kw.get("adc_bits", 9))
            got = qmod._launch(x, K, kc, lead, lay, bits=8,
                               adc_bits=kw.get("adc_bits", 9),
                               conv=kw.get("conv"),
                               per_slice=kw.get("per_slice", False),
                               w_amax=w_amax, weight_bits=8)
            assert len(got) == (2 if w_amax is None else 3)
            if kw.get("per_slice") and w_amax is not None:
                assert got[2].shape == (6, 1, 1)
    assert calls == ["quantize_layout_conv"] * 2 + [
        "quantize_layout_strided"] * 3 + ["quantize_layout_conv"] * 2 + [
        "quantize_layout_strided"] * 3


def test_c_entries_take_given_partial_maxima(monkeypatch):
    """Given partial maxima, the wrapper passes the C entries their
    pointer, their count as ``blocks`` and the flag set, and allocates
    no scratch maxima of its own."""
    import ctypes
    import importlib
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    seen = []

    class Lib:
        def quantize_layout_conv(self, *args):
            seen.append(("conv", args))
            return 0

        def quantize_layout_strided(self, *args):
            seen.append(("strided", args))
            return 0

    monkeypatch.setattr(qmod, "_lib", lambda: Lib())
    monkeypatch.setattr(qmod._build, "stream_handle",
                        lambda: ctypes.c_void_p(0))
    parts = torch.zeros(9)
    for shape, kw, K, _ in GIVEN_CASES.values():
        x = torch.zeros(shape)
        kc, lead = qmod._geometry(x, K, kw.get("conv"))
        lay = call_layout(K, kw.get("rows", 512), kw.get("adc_bits", 9))
        qmod._launch(x, K, kc, lead, lay, bits=8,
                     adc_bits=kw.get("adc_bits", 9), conv=kw.get("conv"),
                     per_slice=False, w_amax=torch.tensor(1.0),
                     weight_bits=8, partials=parts)
    assert [k for k, _ in seen] == ["strided", "strided", "conv", "conv",
                                    "conv", "strided"]
    for kind, args in seen:
        names = qmod.SIGNATURES[f"quantize_layout_{kind}"]
        assert len(args) == len(names)
        assert args[6] == parts.data_ptr() and args[7] == 1
        assert args[-3:-1] == (9, 1)           # blocks, cluster
        assert args[-4] == 0                   # not one launch


# cell -> (graph, static stages, those that take their input's partial
# maxima, ``layout.amax_pass_bytes`` a b1024 batch with and without them)
CELL_PARTS = {
    "resnet18": ("resnet18", 21, 16, 132_120_576, 2_380_267_520),
    "vit_tiny": ("vit_tiny12", 50, 48, 13_369_344, 4_241_227_776),
    "vit_s16": ("vit_s16", 50, 48, 618_135_552, 26_513_768_448),
}


def _meta_cell(name: str, batch: int):
    """(model, its packed program on ``meta`` tensors, a ``meta`` input
    batch) of ``name`` (``CELL_PARTS``' graph names)."""
    import dataclasses
    from repro_torch.program.pack import PackedProgram
    graph = {"vit_tiny12": lambda: tapi.vit_tiny_graph(depth=12),
             "vit_s16": tapi.vit_s16_graph}.get(name, lambda: name)()
    model = tapi.compile(graph, tapi.HurryConfig(), seed=0, device="cpu")
    packed = PackedProgram(stages=tuple(dataclasses.replace(st, **{
        f.name: None if getattr(st, f.name) is None
        else getattr(st, f.name).to("meta")
        for f in dataclasses.fields(st)}) for st in model.packed.stages),
        program=model.program)
    x = torch.zeros(model.program.input_shape(batch), device="meta")
    return model, packed, x


@pytest.mark.parametrize("cell", list(CELL_PARTS))
def test_cells_stages_take_their_inputs_partial_maxima(cell, monkeypatch):
    """The benchmark cells' programs at batch 1024, run on ``meta``
    tensors (shapes only): the static stages whose call takes the partial
    maxima its input's epilogue left are all but the program input's
    (conv0, patch), the stride-2 1x1 projections and the stages after a
    pool or a sequence mean (fc, head); each such call plans 1 or 2
    device kernels, one fewer than without; ``layout.amax_pass_bytes``
    reads what is left (conv0's and patch's images, the projections' even
    pixels, fc's and head's inputs) and, with no partials left, what the
    amax passes read before."""
    import importlib
    execute = importlib.import_module("repro_torch.program.execute")
    name, n_static, engaged, after, before = CELL_PARTS[cell]
    model, packed, x = _meta_cell(name, 1024)
    calls = []
    real = execute.quantize_layout

    def spy(xin, K, **kw):
        calls.append((xin, K, kw))
        return real(xin, K, **kw)

    monkeypatch.setattr(execute, "quantize_layout", spy)
    read = []
    for off in (False, True):
        if off:
            monkeypatch.setattr(execute, "_wants_parts", lambda *a: False)
        calls.clear()
        start = trace.counters().get(execute.AMAX_PASS_BYTES, 0)
        execute.execute_packed(packed, x, return_logits=True)
        read.append(trace.counters()[execute.AMAX_PASS_BYTES] - start)
        static = [c for c in calls if not c[2].get("per_slice")]
        assert len(static) == n_static
        took = [i for i, (_, _, kw) in enumerate(static) if "partials" in kw]
        assert len(took) == (0 if off else engaged)
        if off:
            continue
        stages = [g for g, _ in model.program.stages()
                  if g.kind != "dyn_gemm"]
        own = [stages[i].name for i in range(n_static) if i not in took]
        if cell == "resnet18":
            assert own == ["conv0", "s1b0_proj", "s2b0_proj", "s3b0_proj",
                           "fc"]
        else:
            assert took == list(range(1, n_static - 1))
        for xin, K, kw in static:
            n = device_kernels(xin, K, **kw)
            if "partials" in kw:
                rest = {k: v for k, v in kw.items() if k != "partials"}
                assert n == device_kernels(xin, K, **rest) - 1
                assert n == (2 if kw.get("conv") else 1)
    assert read == [after, before]


def test_variant_anchors_are_lines_of_the_kernel_source():
    """``quantize_variants.py`` edits ``csrc/quantize_layout.cu`` by exact
    source lines: each anchor of its variants and of its probe occurs
    once, so a moved line fails here and not on the card."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import quantize_variants as qv
    finally:
        sys.path.remove(str(root))
    src = Path(qv.CSRC).read_text()
    for name, subs in [*qv.VARIANTS.items(), ("probe", qv.PROBE)]:
        for old, new in subs:
            assert src.count(old) == 1, (name, old)
            assert old != new


@pytest.mark.parametrize("cell", ["resnet18", "vit_tiny"])
def test_stages_run_alone_take_what_they_took_in_the_forward(cell,
                                                             monkeypatch):
    """The partial maxima an epilogue leaves travel in the buffers, beside
    the buffer they cover (``execute.parts_key``), until the last weight
    stage that reads it: each stage of a batch-1024 forward (``meta``
    tensors) run again alone, from a copy of the buffers and the keyword
    arguments it had, makes the forward's ``quantize_layout`` calls, given
    partial maxima where those were, and leaves partial maxima where the
    forward's did; no stage holds an entry past its last reader."""
    import importlib
    execute = importlib.import_module("repro_torch.program.execute")
    name, _, engaged, _, _ = CELL_PARTS[cell]
    model, packed, x = _meta_cell(name, 1024)
    cfg = model.program.cfg
    last = execute._last_reads(model.program.stages())
    real_static, real_dyn = execute._static_stage, execute._dyn_stage
    real_quantize = execute.quantize_layout
    took, runs = [], []

    def quantize(xin, K, **kw):
        took.append("partials" in kw)
        return real_quantize(xin, K, **kw)

    def static(gemm, posts, st, bufs, cfg, **kw):
        runs.append((gemm, posts, st, dict(bufs), kw, len(took)))
        return real_static(gemm, posts, st, bufs, cfg, **kw)

    def dyn(gemm, posts, bufs, cfg, **kw):
        runs.append((gemm, posts, None, dict(bufs), kw, len(took)))
        return real_dyn(gemm, posts, bufs, cfg, **kw)

    monkeypatch.setattr(execute, "quantize_layout", quantize)
    monkeypatch.setattr(execute, "_static_stage", static)
    monkeypatch.setattr(execute, "_dyn_stage", dyn)
    execute.execute_packed(packed, x, return_logits=True)
    forward = list(took)
    assert sum(forward) == engaged
    held = {k for *_, bufs, _, _ in runs for k in bufs}
    for si, (gemm, posts, st, bufs, kw, start) in enumerate(runs):
        assert all(k == model.program.input or last.get(k, -1) >= si
                   for k in bufs), (gemm.name, set(bufs))
        end = runs[si + 1][-1] if si + 1 < len(runs) else len(forward)
        took.clear()
        alone = dict(bufs)
        if st is None:
            real_dyn(gemm, posts, alone, cfg, **kw)
            dst = posts[-1].dst if posts else gemm.dst
        else:
            dst, _ = real_static(gemm, posts, st, alone, cfg, **kw)
        assert took == forward[start:end], gemm.name
        key = execute.parts_key(dst)
        assert (key in alone) == (key in held), gemm.name
