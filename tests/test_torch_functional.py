"""The port's crossbar functional model, CNN forwards and graph oracle
against the JAX package's.

Same seeded numpy inputs and the same weights (``convert.params_from_jax``)
on both sides.  Integer GEMM outputs must be equal; quantized forwards
are bit-exact where the chain is ReLU / max pool only and within stated
tolerances where an average pool, a global mean or the sequence FBs sum
in another order than XLA; the read-noise model, whose draws cannot be
reproduced across the two random generators, is held statistically.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.crossbar import CrossbarConfig as JCfg
from repro.core.crossbar import crossbar_linear as jax_linear
from repro.core.crossbar import crossbar_matmul as jax_matmul
from repro.models import cnn as jcnn
from repro_torch import api as tapi
from repro_torch.convert import params_from_jax
from repro_torch.core.crossbar import CrossbarConfig as TCfg
from repro_torch.core.crossbar import crossbar_linear, crossbar_matmul
from repro_torch.kernels import crossbar_gemm
from repro_torch.kernels.fb_epilogue import avg_windows
from repro_torch.models import cnn as tcnn

from test_torch_program import AVGPOOL_REL, _graphs, _params, _x
from test_torch_sequence import SEQ_REL

# test_torch_sequence.py's bound on whole-network probabilities
SEQ_PROB_ATOL = 1e-3


XBAR = importlib.import_module("repro_torch.core.crossbar")


def _no_kernel(*args, **kw):
    raise AssertionError("crossbar_gemm called")


def _ints(shape, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi, shape,
                                                dtype=np.int32)


def _both(x, w, **cfg_kw):
    """The two packages' crossbar_matmul on the same int32 operands."""
    ref = np.asarray(jax_matmul(jnp.asarray(x), jnp.asarray(w),
                                JCfg(**cfg_kw)))
    got = crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          TCfg(**cfg_kw))
    assert got.dtype == torch.int32
    return got.numpy(), ref


# ---------------------------------------------------------------------------
# crossbar_matmul: int32 outputs equal to JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [27, 300, 1001])
@pytest.mark.parametrize("adc", [8, 9])
@pytest.mark.parametrize("rows", [255, 256, 494, 512])
def test_crossbar_matmul_equals_jax(rows, adc, K):
    """Both branches: exact where min(rows, K) <= 2^adc - 1, sliced (ADC
    clips fire) elsewhere; a third of x and w set to -1 so that bitline
    counts reach the chunk height."""
    x, w = _ints((6, K), -128, 128, K), _ints((K, 20), -128, 128, rows)
    x[:2], w[:, :7] = -1, -1
    got, ref = _both(x, w, rows=rows, adc_bits=adc)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(rows=494, adc_bits=8)])
def test_crossbar_matmul_leading_dims_and_wrap(cfg_kw):
    """(2, 3, K) inputs; operands outside int8 wrap to 8 bits (two's
    complement), as the JAX function's plane decomposition computes."""
    x = _ints((2, 3, 700), -1000, 1000, 1)
    w = _ints((700, 9), -300, 300, 2)
    got, ref = _both(x, w, **cfg_kw)
    assert got.shape == (2, 3, 9)
    np.testing.assert_array_equal(got, ref)


def test_crossbar_matmul_saturating_all_ones_reads_255():
    got, ref = _both(np.ones((1, 512), np.int32), np.ones((512, 1), np.int32),
                     rows=512, adc_bits=8)
    assert int(got[0, 0]) == 255 == int(ref[0, 0])


@pytest.mark.parametrize("cfg_kw", [
    dict(input_bits=4),                           # exact, plain model
    dict(input_bits=4, rows=300, adc_bits=8),     # sliced, plain model
    dict(input_bits=4, weight_bits=6, rows=64, adc_bits=5),
])
def test_crossbar_matmul_other_bit_widths(cfg_kw, monkeypatch):
    """Other widths than 8/8 take the plain exact or sliced model, never
    the 8-plane kernel (monkeypatched to fail)."""
    monkeypatch.setattr(XBAR, "crossbar_gemm", _no_kernel)
    x, w = _ints((5, 333), -100, 100, 3), _ints((333, 11), -100, 100, 4)
    got, ref = _both(x, w, **cfg_kw)
    np.testing.assert_array_equal(got, ref)


def test_eight_bit_calls_go_through_crossbar_gemm(monkeypatch):
    """Noise-free 8-bit calls are one crossbar_gemm call on the wrapped
    int8 operands, with the config's rows and ADC and the kernel's own
    branch choice (exact=None)."""
    calls = []

    def spy(x, w, **kw):
        calls.append((x.dtype, w.dtype, x.shape, kw))
        return crossbar_gemm(x, w, **kw)

    monkeypatch.setattr(XBAR, "crossbar_gemm", spy)
    x, w = _ints((2, 3, 40), -200, 200, 8), _ints((40, 5), -200, 200, 9)
    got, ref = _both(x, w, rows=494, adc_bits=8)
    np.testing.assert_array_equal(got, ref)
    assert calls == [(torch.int8, torch.int8, (6, 40),
                      dict(adc_bits=8, rows=494))]


def test_crossbar_matmul_slice_axis_equals_per_slice_calls():
    """(S, M, K) x (S, K, N) is S independent GEMMs, as jax.vmap."""
    x, w = _ints((4, 7, 600), -128, 128, 5), _ints((4, 600, 13), -128, 128, 6)
    cfg = dict(rows=512, adc_bits=9)
    ref = np.asarray(jax.vmap(lambda a, b: jax_matmul(a, b, JCfg(**cfg)))(
        jnp.asarray(x), jnp.asarray(w)))
    got = crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          TCfg(**cfg)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sliced", [False, True])
def test_crossbar_linear_against_jax(sliced):
    """Per-tensor quantization (2-D weight) and per-slice quantization
    (3-D weight, against jax.vmap) within 1e-6 relative."""
    rng = np.random.default_rng(7)
    cfg = dict(rows=256, adc_bits=8 if sliced else 9)
    x = rng.standard_normal((16, 300)).astype(np.float32)
    w = (rng.standard_normal((300, 48)) / 14).astype(np.float32)
    xs = rng.standard_normal((6, 10, 64)).astype(np.float32)
    ws = rng.standard_normal((6, 64, 10)).astype(np.float32)
    fn = jax.jit(lambda a, b: jax_linear(a, b, JCfg(**cfg)))
    for a, b, ref in [(x, w, fn(x, w)), (xs, ws, jax.vmap(fn)(xs, ws))]:
        got = crossbar_linear(torch.from_numpy(a), torch.from_numpy(b),
                              TCfg(**cfg)).numpy()
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# read noise, held statistically
# ---------------------------------------------------------------------------

def _noise_rel(matmul, make_key, x, w, sigma, draws=4):
    """mean |noisy - exact| / mean |exact| over ``draws`` noise draws."""
    exact = x.astype(np.int64) @ w.astype(np.int64)
    errs = [np.abs(np.asarray(matmul(x, w, sigma, make_key(i))) - exact)
            .mean() for i in range(draws)]
    return np.mean(errs) / np.abs(exact).mean()


def _noise_inputs():
    # tests/test_crossbar.py's shapes and config: 8x256 by 256x32, rows 256
    return _ints((8, 256), -128, 128, 0), _ints((256, 32), -128, 128, 1)


def test_noise_statistic_matches_jax():
    """The port's relative noise error is within 15% of JAX's at sigma
    0.5 and 2.0 (four draws each side) and grows with sigma; the
    config is clip-free, so the noisy path is taken regardless."""
    x, w = _noise_inputs()

    def jmm(x, w, s, key):
        return jax_matmul(jnp.asarray(x), jnp.asarray(w),
                          JCfg(rows=256, noise_sigma_thermal=s), key)

    def tmm(x, w, s, gen):
        return crossbar_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               TCfg(rows=256, noise_sigma_thermal=s), gen)

    assert TCfg(rows=256, noise_sigma_thermal=2.0).clip_free
    ports = []
    for sigma in (0.5, 2.0):
        ref = _noise_rel(jmm, lambda i: jax.random.PRNGKey(7 + i), x, w,
                         sigma)
        got = _noise_rel(tmm, lambda i: torch.Generator().manual_seed(7 + i),
                         x, w, sigma)
        assert got > 0 and abs(got - ref) <= 0.15 * ref, (sigma, got, ref)
        ports.append(got)
    assert ports[0] < ports[1]


def test_noisy_path_is_seeded_and_skips_the_kernel(monkeypatch):
    x, w = map(torch.from_numpy, _noise_inputs())
    cfg = TCfg(rows=256, noise_sigma_thermal=2.0)
    exact = crossbar_matmul(x, w, cfg)          # no generator: no noise
    monkeypatch.setattr(XBAR, "crossbar_gemm", _no_kernel)
    a = crossbar_matmul(x, w, cfg, torch.Generator().manual_seed(3))
    b = crossbar_matmul(x, w, cfg, torch.Generator().manual_seed(3))
    c = crossbar_matmul(x, w, cfg, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, exact)


# ---------------------------------------------------------------------------
# models/cnn.py and NetworkGraph.forward against jax.jit of JAX's
# ---------------------------------------------------------------------------

def _net_inputs(net, seed=1):
    jgraph, tgraph = _graphs(net)
    params = _params(jgraph, seed)
    return (jgraph, tgraph, jax.tree.map(jnp.asarray, params),
            params_from_jax(params), _x(jgraph, 2))


def _close_logits(got, ref, rel):
    assert (got.argmax(1) == ref.argmax(1)).all()
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("net,crossbar", [
    ("alexnet", False), ("vgg16", False), ("resnet18", False),
    ("alexnet", True), ("vgg16", True), ("resnet18", True)])
def test_cnn_forwards_against_jax(net, crossbar):
    """fp_matmul: rtol 1e-4 (float32 GEMMs summed in other orders).
    Crossbar: AlexNet at 512 rows / 9 bits (stages with K >= 512 on the
    sliced model), VGG-16 and ResNet-18 at 511 rows (clip-free: the
    exact model, cheaper on the CPU); AlexNet and VGG-16 bit-exact (ReLU
    / max pool chains), ResNet-18's global mean sums in another order,
    so argmax and AVGPOOL_REL."""
    _, _, jp, tp, x = _net_inputs(net)
    cfg = dict(rows=512 if net == "alexnet" else 511, adc_bits=9)
    jmm = jcnn.make_crossbar_matmul(JCfg(**cfg)) if crossbar \
        else jcnn.fp_matmul
    tmm = tcnn.make_crossbar_matmul(TCfg(**cfg)) if crossbar \
        else tcnn.fp_matmul
    ref = np.asarray(jax.jit(lambda p, v: jcnn.CNN_MODELS[net].forward(
        p, v, mm=jmm))(jp, jnp.asarray(x)))
    got = tcnn.CNN_MODELS[net].forward(tp, torch.from_numpy(x), mm=tmm)
    got = got.numpy()
    assert got.shape == ref.shape == (2, 10)
    if not crossbar:
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    elif net == "resnet18":
        _close_logits(got, ref, AVGPOOL_REL)
    else:
        np.testing.assert_array_equal(got, ref)


def _token_graph(api):
    """A small token-input graph with every sequence FB: attention, layer
    norm, GELU, residuals, sequence mean, softmax."""
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


def _token_params(jgraph, seed=2):
    params = jax.tree.map(np.asarray, jgraph.init_params(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return {k: {n: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                    if v.ndim == 1 else v) for n, v in p.items()}
            for k, p in params.items()}


@pytest.mark.parametrize("net,cfg_kw,crossbar", [
    ("custom8", dict(), False),
    ("custom8", dict(), True),
    ("alexnet", dict(adc_bits=8), True),
    ("tok", dict(), False),
    ("tok", dict(), True),
])
def test_graph_forward_against_jax(net, cfg_kw, crossbar):
    """fp_matmul: rtol 1e-4.  Crossbar: AlexNet at adc_bits=8 (every stage
    but conv1 sliced) bit-exact; custom8 (average pool) argmax and
    AVGPOOL_REL; the token graph (attention's per-slice quantization,
    GELU, layer norm, sequence mean, softmax) to test_torch_sequence's
    SEQ_REL, its probabilities to SEQ_PROB_ATOL."""
    if net == "tok":
        jgraph, tgraph = _token_graph(japi), _token_graph(tapi)
        params = _token_params(jgraph)
        x = np.random.default_rng(0).standard_normal(
            (2, 12, 32)).astype(np.float32)
    else:
        jgraph, tgraph = _graphs(net)
        params = _params(jgraph)
        x = _x(jgraph, 2)
    jcfg = japi.HurryConfig(**cfg_kw).crossbar()
    tcfg = tapi.HurryConfig(**cfg_kw).crossbar()
    jmm = jcnn.make_crossbar_matmul(jcfg) if crossbar else jcnn.fp_matmul
    tmm = tcnn.make_crossbar_matmul(tcfg) if crossbar else tcnn.fp_matmul
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params)
    fwd = jax.jit(lambda p, v, lg: jgraph.forward(p, v, mm=jmm, logits=lg),
                  static_argnums=2)
    ref = np.asarray(fwd(jp, jnp.asarray(x), True))
    got = tgraph.forward(tp, torch.from_numpy(x), mm=tmm, logits=True)
    got = got.numpy()
    if not crossbar:
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    elif net == "alexnet":
        np.testing.assert_array_equal(got, ref)
    elif net == "custom8":
        _close_logits(got, ref, AVGPOOL_REL)
    else:
        _close_logits(got, ref, SEQ_REL)
        probs = tgraph.forward(tp, torch.from_numpy(x), mm=tmm).numpy()
        np.testing.assert_allclose(
            probs, np.asarray(fwd(jp, jnp.asarray(x), False)), rtol=0,
            atol=SEQ_PROB_ATOL)


@pytest.mark.parametrize("net,cfg_kw", [
    ("custom8", dict()), ("alexnet", dict(adc_bits=8)),
    ("vgg16", dict(array_rows=511)), ("resnet18", dict(array_rows=511)),
    ("tok", dict())])
def test_graph_forward_equals_own_run_bitwise(net, cfg_kw):
    """In eager PyTorch on the CPU the crossbar oracle equals the
    compiled program's logits bit for bit, average pool and sequence FBs
    included: both quantize, requantize and add the bias in the same
    roundings and share the FB bodies' plain functions.  (AlexNet at
    adc_bits=8 holds the sliced model; the two deeper nets run
    clip-free, on the exact one.)"""
    if net == "tok":
        tgraph = _token_graph(tapi)
        x = np.random.default_rng(0).standard_normal(
            (3, 12, 32)).astype(np.float32)
    else:
        _, tgraph = _graphs(net)
        x = _x(tgraph, 3)
    cfg = tapi.HurryConfig(**cfg_kw)
    model = tapi.compile(tgraph, cfg, seed=4, device="cpu")
    got = tgraph.forward(model.params, torch.from_numpy(x),
                         mm=tcnn.make_crossbar_matmul(cfg.crossbar()),
                         logits=True)
    assert torch.equal(got, model.run(x, logits=True))


def test_program_forward_equals_compiled_run():
    _, tgraph = _graphs("custom8")
    model = tapi.compile(tgraph, seed=5, device="cpu")
    x = torch.from_numpy(_x(tgraph, 2))
    fwd = tcnn.make_program_forward(tgraph, cfg=model.program.cfg)
    assert torch.equal(fwd(model.params, x), model.run(x, logits=True))
    probs = tcnn.make_program_forward(tgraph, return_logits=False)(
        model.params, x)
    assert torch.equal(probs, model.run(x))


def test_cnn_init_is_the_graphs_and_seeded():
    a = tcnn.CNN_MODELS["alexnet"].init(torch.Generator().manual_seed(3))
    b = tapi.GRAPHS["alexnet"]().init_params(torch.Generator().manual_seed(3))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])
    assert a["conv1"]["w"].shape == (3, 3, 3, 64)


def test_primitives_against_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tcnn.im2col(torch.from_numpy(x), 3, 2, 1).numpy(),
        np.asarray(jcnn.im2col(jnp.asarray(x), 3, 2, 1)))
    np.testing.assert_array_equal(
        tcnn.maxpool(torch.from_numpy(x)).numpy(),
        np.asarray(jcnn.maxpool(jnp.asarray(x))))


def test_graph_forward_avgpool_sums_in_the_kernels_order():
    """``graph.forward``'s average pool sums each window in row-major
    order, as the ``fb_epilogue`` kernel and its plain version do, on
    every device; a ``mean`` reduction orders its sums by device (on the
    CPU it already differs on mixed-scale windows).  Identity 1x1 conv
    and fc weights pass the pooled values through to the logits."""
    C = 10
    nb = tapi.NetworkBuilder("pool", input_hw=4, input_ch=C)
    nb.conv(C, k=1, padding=0, name="c")
    nb.avgpool(k=4, stride=4, name="gap")
    nb.fc(C, name="fc")
    graph = nb.build()
    eye = torch.eye(C)
    params = {"c": {"w": eye.reshape(1, 1, C, C), "b": torch.zeros(C)},
              "fc": {"w": eye, "b": torch.zeros(C)}}
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(64, 4, 4, C, generator=g)
         * torch.logspace(-4, 4, 16).reshape(1, 4, 4, 1))
    got = graph.forward(params, x, logits=True)
    want = avg_windows(x.reshape(64, 1, 4, 1, 4, C)).reshape(64, C)
    assert torch.equal(got, want)
    assert not torch.equal(x.reshape(64, 1, 4, 1, 4, C).mean(dim=(2, 4))
                           .reshape(64, C), want)
