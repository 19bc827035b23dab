"""The port's save/load, ProgramServer and simulate against the JAX
package's.

Files cross both ways: a model saved by ``repro.api`` loads in the port
and runs bit for bit like the port's own compile of the same weights; a
model saved by the port loads in ``repro.api`` and runs bit for bit like
JAX's in-memory model (the packed int8 planes are equal, so the same
jitted executor sees the same arrays).  The analytical chip model is
pure Python over the same ``LayerSpec`` lists, so its reports must be
equal, not close.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro_torch.api as tapi
import repro_torch.core as tcore
from repro_torch.convert import params_from_jax
from repro_torch.program.serve import make_server

from test_torch_functional import _token_graph, _token_params
from test_torch_program import WIDTHS, _graphs, _params, _x


def _case(net):
    """(JAX graph, port graph, numpy params, input of batch 2, config
    kwargs) of one held save/load case."""
    if net == "tok":
        jgraph, tgraph = _token_graph(japi), _token_graph(tapi)
        params = _token_params(jgraph)
        x = np.random.default_rng(0).standard_normal(
            (2, 12, 32)).astype(np.float32)
        return jgraph, tgraph, params, x, dict()
    jgraph, tgraph = _graphs(net)
    return (jgraph, tgraph, _params(jgraph), _x(jgraph, 2),
            dict(adc_bits=8) if net == "alexnet" else dict())


def _same_meta(a, b):
    """config, program (ops, cfg, buffers) and graph layers equal field
    for field (the two packages' dataclasses are distinct types)."""
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert dataclasses.asdict(a.program.cfg) == dataclasses.asdict(
        b.program.cfg)
    assert [dataclasses.asdict(o) for o in a.program.ops] == [
        dataclasses.asdict(o) for o in b.program.ops]
    assert [dataclasses.asdict(l) for l in a.graph.layers] == [
        dataclasses.asdict(l) for l in b.graph.layers]
    assert a.graph.name == b.graph.name and a.buckets == b.buckets


# ---------------------------------------------------------------------------
# save / load, both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["custom8", "alexnet", "tok"])
def test_jax_file_loads_in_the_port(net, tmp_path, monkeypatch):
    """custom8 (every CNN FB), AlexNet at adc_bits=8 (sliced stages) and a
    token graph (dynamic placeholders, ln_stages): loading neither
    compiles nor quantizes (both monkeypatched to fail), and ``run``
    equals the port's own compile of the same params."""
    jgraph, tgraph, params, x, cfg_kw = _case(net)
    jm = japi.compile(jgraph, japi.HurryConfig(**cfg_kw),
                      params=jax.tree.map(jnp.asarray, params))
    path = jm.save(str(tmp_path / "m.npz"))
    tm = tapi.compile(tgraph, tapi.HurryConfig(**cfg_kw),
                      params=params_from_jax(params), device="cpu")

    def fail(*a, **k):
        raise AssertionError("load compiled or quantized")

    for mod, name in [("repro_torch.api.model", "compile_network"),
                      ("repro_torch.api.serialize", "pack_program"),
                      ("repro_torch.program.pack", "quantize_with_scale")]:
        monkeypatch.setattr(importlib.import_module(mod), name, fail)
    loaded = tapi.load(path, device="cpu")
    monkeypatch.undo()
    _same_meta(loaded, tm)
    for a, b in zip(loaded.packed.stages, tm.packed.stages):
        assert torch.equal(a.w8, b.w8) and torch.equal(a.bias, b.bias)
        assert (a.wt is None) == (b.wt is None)
        assert a.wt is None or torch.equal(a.wt, b.wt)
    assert loaded.device == torch.device("cpu")
    assert torch.equal(loaded.run(x, logits=True), tm.run(x, logits=True))
    assert torch.equal(loaded.run(x), tm.run(x))


@pytest.mark.parametrize("net", ["custom8", "alexnet", "tok"])
def test_port_file_loads_in_jax(net, tmp_path):
    """The port's file in ``repro.api.load``: the same meta, planes equal
    to JAX's own packing, and ``run`` bit for bit JAX's in-memory
    model's."""
    jgraph, tgraph, params, x, cfg_kw = _case(net)
    tm = tapi.compile(tgraph, tapi.HurryConfig(**cfg_kw),
                      params=params_from_jax(params), device="cpu")
    path = tm.save(str(tmp_path / "m.npz"))
    jl = japi.load(path)
    jm = japi.compile(jgraph, japi.HurryConfig(**cfg_kw),
                      params=jax.tree.map(jnp.asarray, params))
    _same_meta(jl, jm)
    assert jl.config == jm.config and jl.program.ops == jm.program.ops
    for a, b in zip(jl.packed.stages, jm.packed.stages):
        for f in ("w8", "w_amax", "bias", "ln_g", "ln_b"):
            u, v = getattr(a, f), getattr(b, f)
            assert (u is None) == (v is None)
            assert u is None or np.array_equal(np.asarray(u), np.asarray(v))
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(np.asarray(jl.run(xj, logits=True)),
                                  np.asarray(jm.run(xj, logits=True)))


def test_port_round_trip_and_version_1_repack(tmp_path):
    _, tgraph, params, x, _ = _case("custom8")
    tm = tapi.compile(tgraph, tapi.HurryConfig(), buckets=(1, 4),
                      params=params_from_jax(params), device="cpu")
    path = tm.save(str(tmp_path / "m.npz"))
    loaded = tapi.load(path, device="cpu")
    _same_meta(loaded, tm)
    assert loaded.buckets == (1, 4)
    want = tm.run(x, logits=True)
    assert torch.equal(loaded.run(x, logits=True), want)
    # a version-1 file: params only, no planes; the loader repacks once
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k.startswith("p")}
        meta = json.loads(str(z["__meta__"][()]))
    meta["version"] = 1
    del meta["packed_stages"], meta["ln_stages"]
    v1 = str(tmp_path / "v1.npz")
    np.savez(v1, __meta__=np.asarray(json.dumps(meta)), **arrays)
    assert torch.equal(tapi.load(v1, device="cpu").run(x, logits=True), want)


def test_port_round_trip_keeps_other_widths(tmp_path):
    """4-bit operands on a 5-bit ADC survive ``save`` / ``load``: the
    loaded config is the saved one and ``run`` is unchanged."""
    _, tgraph, params, x, _ = _case("custom8")
    cfg = tapi.HurryConfig(**WIDTHS["w4a4_adc5"])
    tm = tapi.compile(tgraph, cfg, params=params_from_jax(params),
                      device="cpu")
    loaded = tapi.load(tm.save(str(tmp_path / "m.npz")), device="cpu")
    _same_meta(loaded, tm)
    assert loaded.config == cfg
    assert torch.equal(loaded.run(x, logits=True), tm.run(x, logits=True))


@pytest.mark.parametrize("edit,match", [
    (dict(version=99), "format version 99"),
    (dict(format="something/else"), "not a repro.api/compiled-model"),
    (dict(packed_stages=2), "2 packed weight planes for"),
])
def test_load_rejects_unknown_and_corrupt_files(edit, match, tmp_path):
    _, tgraph, params, _, _ = _case("custom8")
    tm = tapi.compile(tgraph, params=params_from_jax(params), device="cpu")
    path = tm.save(str(tmp_path / "m.npz"))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("__meta__")[()]))
    meta.update(edit)
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)
    with pytest.raises(ValueError, match=match):
        tapi.load(path, device="cpu")


def test_load_without_device_raises_on_a_gpu_less_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    _, tgraph, params, _, _ = _case("custom8")
    path = tapi.compile(tgraph, params=params_from_jax(params),
                        device="cpu").save(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.load(path)


# ---------------------------------------------------------------------------
# ProgramServer / make_server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("buckets", [(1, 2, 4, 8), None])
@pytest.mark.parametrize("logits", [False, True])
def test_server_is_bitwise_compiled_model_run(buckets, logits):
    """Batches 1, 3 and 5 (3 and 5 pad up to a bucket where there is a
    ladder) equal ``CompiledModel.run`` on the same packed program."""
    _, tgraph, params, _, _ = _case("custom8")
    tp = params_from_jax(params)
    cfg = tapi.HurryConfig()
    server = make_server(tgraph, tp, config=cfg, return_logits=logits,
                         buckets=buckets, donate_input=True, device="cpu")
    model = tapi.compile(tgraph, cfg, params=tp, device="cpu")
    assert server.buckets == tuple(buckets or ())
    assert server.program.ops == model.program.ops
    for b in (1, 3, 5):
        x = _x(tgraph, b, seed=b)
        got = server(x)
        assert got.shape == (b, 10)
        assert torch.equal(got, model.run(x, logits=logits))
    server.warmup(batch=3)


def test_make_server_inits_the_named_cnns_and_derives_its_config():
    """``params=None``: the zoo CNN's init from a generator seeded with
    ``seed``, the same weights ``api.compile`` draws; ``cfg`` wins over
    ``config``'s derivation; non-registry nets need params."""
    cfg511 = tapi.HurryConfig(array_rows=511)
    server = make_server("alexnet", config=cfg511, seed=3, device="cpu")
    model = tapi.compile("alexnet", cfg511, seed=3, device="cpu")
    assert server.program.cfg == cfg511.crossbar()
    assert all(torch.equal(server.params[k][n], model.params[k][n])
               for k in model.params for n in model.params[k])
    x = _x(model.graph, 2)
    assert torch.equal(server(x), model.run(x))
    cfg = tcore.CrossbarConfig(rows=256, adc_bits=9)
    s2 = make_server("alexnet", params=model.params, cfg=cfg,
                     config=tapi.HurryConfig(), device="cpu")
    assert s2.program.cfg == cfg
    _, tgraph = _graphs("custom8")
    with pytest.raises(ValueError, match="params are required"):
        make_server(tgraph, device="cpu")


# ---------------------------------------------------------------------------
# simulate
# ---------------------------------------------------------------------------

GEOMETRIES = [dict(), dict(array_rows=256, array_cols=256, adc_bits=8,
                           n_tiles=8, sim_batch=4)]


@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)))
@pytest.mark.parametrize("net", ["alexnet", "vgg16", "resnet18"])
def test_simulate_equals_jax_on_every_arch(net, geometry):
    kw = GEOMETRIES[geometry]
    tm = tapi.compile(net, tapi.HurryConfig(**kw), device="cpu")
    # the JAX reference needs only the graph and config: no packing
    jm = japi.CompiledModel(graph=japi.GRAPHS[net](),
                            config=japi.HurryConfig(**kw), program=None,
                            params={})
    assert tapi.SIM_ARCHS == japi.SIM_ARCHS
    for arch in tapi.SIM_ARCHS:
        got, ref = tm.simulate(arch), jm.simulate(arch)
        assert got.name == ref.name
        assert got.summary() == ref.summary(), arch
        assert dataclasses.asdict(got.energy) == dataclasses.asdict(
            ref.energy)
        assert got.latency_cycles == ref.latency_cycles


def test_simulate_rejects_sequence_graphs_and_unknown_archs():
    model = tapi.compile("vit_tiny", device="cpu")
    with pytest.raises(ValueError, match="sequence workloads"):
        model.simulate()
    with pytest.raises(ValueError, match="unknown arch"):
        model.simulate("isaac-64")


def test_baseline_config_equals_jax():
    for kw, over in [(dict(), dict()), (GEOMETRIES[1], dict(unit_array=256))]:
        got = tapi.HurryConfig(**kw).baseline(**over)
        ref = japi.HurryConfig(**kw).baseline(**over)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_packages_export_what_the_jax_packages_export():
    """``repro_torch.api`` and ``repro_torch.core`` name every public name
    of ``repro.api`` / ``repro.core``, each importable."""
    for tpkg, jpkg in [(tapi, japi), (tcore, jcore)]:
        assert set(jpkg.__all__) <= set(tpkg.__all__), \
            set(jpkg.__all__) - set(tpkg.__all__)
        for name in tpkg.__all__:
            assert getattr(tpkg, name) is not None
    with pytest.warns(DeprecationWarning):
        layers = tcore.WORKLOADS["vgg16"]()
    assert [dataclasses.asdict(l) for l in layers] == [
        dataclasses.asdict(l) for l in japi.vgg16_graph().layers]
