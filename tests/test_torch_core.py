"""The PyTorch port's pure layers against the JAX package, on the CPU.

Quantization must be bit-exact against jitted JAX (the port writes it in
the reciprocal form XLA compiles), the compiler must emit op lists equal
field for field, the config derivations must agree, and the port must
import neither JAX nor anything of the JAX package.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.crossbar import quantize_scale as jax_quantize_scale
from repro.core.crossbar import quantize_symmetric as jax_quantize_symmetric
from repro.program.compile import compile_network as jax_compile_network
from repro_torch import api as tapi
from repro_torch.core.crossbar import (dequant_scale, quantize_scale,
                                       quantize_symmetric)
from repro_torch.program.compile import compile_network

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _quant_inputs(n: int = 240, seed: int = 0):
    """Seeded tensors over 7 decades; every third one sits on .5 ties.

    Shapes come from a short list so the jitted reference compiles once
    per shape.
    """
    rng = np.random.default_rng(seed)
    shapes = [(1, 7), (3, 27), (16, 100), (33, 190), (64, 64), (47, 129)]
    for i in range(n):
        shape = shapes[i % len(shapes)]
        x = (rng.standard_normal(shape)
             * 10 ** rng.uniform(-4, 3)).astype(np.float32)
        if i % 3 == 0:   # (k + 0.5) * scale: exactly at rounding ties
            amax = np.float32(np.abs(x).max())
            s = amax * np.float32(1 / 127)
            k = rng.integers(-127, 127, size=shape)
            x = ((k + 0.5) * s).astype(np.float32)
            x.flat[0] = amax
        yield x


def test_quantize_symmetric_bit_exact_vs_jitted_jax():
    jq = jax.jit(jax_quantize_symmetric)
    n_tensors = n_values = 0
    for x in _quant_inputs():
        q_ref, s_ref = jq(x)
        q, s = quantize_symmetric(torch.from_numpy(x))
        assert q.dtype == torch.int32
        assert np.float32(s_ref) == s.numpy(), "scale differs"
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        n_tensors += 1
        n_values += x.size
    assert n_tensors >= 200 and n_values > 5 * 10 ** 5


def test_quantize_scale_and_dequant_scale_bit_exact_vs_jitted_jax():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(0, 100, 500), rng.uniform(0, 1e-7, 20),
                        [0.0, 1e-8, 127.0]]).astype(np.float32)
    b = rng.uniform(0, 3, a.size).astype(np.float32)
    sa = jax.jit(jax.vmap(jax_quantize_scale))(a)
    np.testing.assert_array_equal(
        quantize_scale(torch.from_numpy(a)).numpy(), np.asarray(sa))
    # the executor's requant factor is a product of two scalar scales,
    # which XLA reassociates (dequant_scale docstring)
    prod = jax.jit(lambda u, v: jax_quantize_scale(u) * jax_quantize_scale(v))
    got = [dequant_scale(torch.tensor(u), torch.tensor(v)).item()
           for u, v in zip(a, b)]
    np.testing.assert_array_equal(
        np.float32(got), np.float32([prod(u, v) for u, v in zip(a, b)]))


@pytest.mark.parametrize("net", ["alexnet", "vgg16", "resnet18", "vit_tiny"])
def test_compile_network_op_lists_equal_jax(net):
    ref = jax_compile_network(net, config=japi.HurryConfig())
    got = compile_network(net, config=tapi.HurryConfig())
    assert [dataclasses.astuple(o) for o in got.ops] == \
        [dataclasses.astuple(o) for o in ref.ops]
    assert (got.input, got.output, got.logits, got.input_shape(2)) == \
        (ref.input, ref.output, ref.logits, ref.input_shape(2))
    assert [dataclasses.astuple(p) for p in got.plans] == \
        [dataclasses.astuple(p) for p in ref.plans]


@pytest.mark.parametrize("kw", [dict(), dict(adc_bits=8),
                                dict(array_rows=511, n_tiles=4)])
def test_hurry_config_derivations_equal_jax(kw):
    ref, got = japi.HurryConfig(**kw), tapi.HurryConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.chip()) == dataclasses.asdict(ref.chip())
    assert dataclasses.asdict(got.crossbar()) == \
        dataclasses.asdict(ref.crossbar())
    assert got.clip_free == ref.clip_free
    assert tapi.HurryConfig.from_chip(got.chip()) == \
        tapi.HurryConfig(**{**kw, "adc_bits": 9})


@pytest.mark.parametrize("net", ["alexnet", "resnet18", "vit_tiny"])
def test_zoo_graphs_equal_jax(net):
    ref, got = japi.GRAPHS[net](), tapi.GRAPHS[net]()
    assert [dataclasses.astuple(l) for l in got.layers] == \
        [dataclasses.astuple(l) for l in ref.layers]
    assert got.input_shape(3) == ref.input_shape(3)


def test_builder_rejects_what_jax_rejects():
    nb = tapi.NetworkBuilder("bad", input_hw=8, input_ch=3)
    with pytest.raises(ValueError, match="'relu0'.*precedes any GEMM"):
        nb.relu(name="relu0")
    nb = tapi.NetworkBuilder("bad", input_hw=8, input_ch=3)
    nb.conv(8, name="c")
    with pytest.raises(ValueError, match="window == stride"):
        nb.maxpool(k=3, stride=2)


def test_init_params_shapes_match_jax_and_seed_is_deterministic():
    graph = tapi.GRAPHS["resnet18"]()
    a = graph.init_params(torch.Generator().manual_seed(3))
    b = graph.init_params(torch.Generator().manual_seed(3))
    ref = jax.eval_shape(japi.GRAPHS["resnet18"]().init_params,
                         jax.random.PRNGKey(0))
    assert a.keys() == ref.keys()
    for k in a:
        assert {n: tuple(t.shape) for n, t in a[k].items()} == \
            {n: tuple(v.shape) for n, v in ref[k].items()}
        for n in a[k]:
            assert torch.equal(a[k][n], b[k][n])


def test_compile_without_device_raises_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.compile("alexnet")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of repro_torch imports with neither jax nor repro.*."""
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'repro.')) or k == 'repro']\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 20


def test_port_sources_never_import_jax_or_the_jax_package():
    offenders = []
    for p in (SRC / "repro_torch").rglob("*.py"):
        for ln in p.read_text().splitlines():
            s = ln.strip()
            if s.startswith(("import jax", "from jax", "from repro.",
                             "import repro.", "from repro import")):
                offenders.append(f"{p.name}: {s}")
    assert not offenders, offenders


def test_quantize_zero_tensor_uses_the_amax_floor():
    """The 1e-8 amax floor: an all-zero tensor quantizes to zeros."""
    q, s = quantize_symmetric(torch.zeros(3, 4))
    q_ref, s_ref = jax.jit(jax_quantize_symmetric)(jnp.zeros((3, 4)))
    assert not q.any() and np.float32(s_ref) == s.numpy()
