"""Pre-norm transformer blocks on the port's program path.

A pre-norm block (``x = x + f(LN(x))``) reads the residual stream ``x``
before the layer norm that closes the group computing it: the builder
takes such a source as the group's *tap* (``core.workload.group_tap``),
the compiler makes it a second output of the stage
(``CrossbarProgram.taps``), and ``fb_epilogue`` stores it beside the
normalized rows in the same call.  Held here on the CPU, against the
benchmark's plain reference (``bench/reference/hurry.py``) and the
functional interpreter; no JAX (the JAX builder has no taps).
"""

import pytest
import torch

from bench.harness import layers as L
from bench.harness import program as bench_program
from bench.reference.hurry import Reference
from repro_torch import api, trace
from repro_torch.core.simulator import LN_ROWS
from repro_torch.core.workload import LayerSpec
from repro_torch.kernels import clip_possible, fb_epilogue, fb_epilogue_ref
from repro_torch.kernels.fb_epilogue import layer_norm_rows
from repro_torch.models.cnn import make_crossbar_matmul
from repro_torch.program import execute
from repro_torch.program.compile import compile_network

# a small ViT-S/16 wiring: 32x32 images, patch 8 (16 tokens), width 96,
# 3 heads, 2 blocks, 10 classes; and the published geometry
SMALL = dict(depth=2, dim=96, heads=3, patch=8, input_hw=32, classes=10)
FULL = dict(depth=12, dim=384, heads=6, patch=16, input_hw=224, classes=1000)
HURRY = dict(weight_bits=8, input_bits=8, adc_bits=9, dac_bits=1,
             cell_bits=1, array_rows=512, array_cols=512)
INIT = {"weights": 0.02, "bias_std": 0.02, "norm_std": 0.1}


def _config(depth, dim, heads, patch, input_hw, classes):
    """The small preset as a benchmark configuration (the harness's
    layer list), wired as ``bench/configs/vit_s16.json``."""
    layers = [{"name": "patch", "kind": "conv", "out": dim, "k": patch,
               "stride": patch, "pad": 0}]
    x = "patch"
    for i in range(depth):
        layers += [{"name": f"b{i}_ln1", "kind": "layernorm"},
                   {"name": f"b{i}_attn", "kind": "attention",
                    "heads": heads},
                   {"name": f"b{i}_res1", "kind": "residual", "source": x},
                   {"name": f"b{i}_ln2", "kind": "layernorm"},
                   {"name": f"b{i}_fc1", "kind": "linear", "out": 4 * dim},
                   {"name": f"b{i}_gelu", "kind": "gelu"},
                   {"name": f"b{i}_fc2", "kind": "linear", "out": dim},
                   {"name": f"b{i}_res2", "kind": "residual",
                    "source": f"b{i}_res1"}]
        x = f"b{i}_res2"
    layers += [{"name": "ln", "kind": "layernorm"},
               {"name": "pool", "kind": "seqpool"},
               {"name": "head", "kind": "fc", "out": classes},
               {"name": "softmax", "kind": "softmax"}]
    return {"name": "vit_s16", "image_size": input_hw, "num_channels": 3,
            "init": INIT, "hurry": HURRY, "layers": layers}


def small_graph():
    """The small preset, built by the harness from its layer list."""
    return bench_program.graph(_config(**SMALL))


def _small(seed=2**31 + 5, batch=3):
    """(config, params, images, model on the CPU) of the small preset."""
    cfg = _config(**SMALL)
    layers = L.infer(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = L.make_params(layers, cfg["init"], gen)
    x = L.make_images(batch, cfg, gen)
    model = api.compile(small_graph(), api.HurryConfig(**HURRY),
                        params=params, device="cpu")
    return cfg, params, x, model


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

def test_builder_takes_taps_and_a_layer_norm_after_a_conv():
    g = small_graph()
    kinds = {l.name: l for l in g.layers}
    assert kinds["b0_ln1"].kind == "layernorm"
    assert kinds["b0_res1"].residual_from == "patch"
    assert kinds["b1_res1"].residual_from == "b0_res2"
    assert kinds["b1_res2"].residual_from == "b1_res1"
    # the preset's layer list is the zoo's wiring at the published geometry
    assert bench_program.graph(_config(**FULL)).layers == \
        api.vit_s16_graph().layers


def test_builder_still_rejects_what_it_rejected():
    nb = api.NetworkBuilder("bad", input_hw=8, input_ch=3)
    nb.conv(16, name="c1")
    with pytest.raises(ValueError, match="'g1'.*sequence FB but its group "
                       "head is a conv; gelu/layernorm/seqpool fuse onto "
                       "linear or attention group heads only$"):
        nb.gelu(name="g1")
    nb.layernorm(name="ln1")          # a conv group may close with one
    nb.attention(4, name="a")
    # a residual source not yet computed, or inside the open group
    with pytest.raises(ValueError, match="'fc9' is not a materialized"):
        nb.residual("fc9", name="r0")
    with pytest.raises(ValueError, match="'a' is not a materialized"):
        nb.residual("a", name="r0")
    # wiring an input to a tap stays refused (taps feed residuals only)
    with pytest.raises(ValueError, match="input_from='c1' is not a "
                       "materialized group output"):
        nb.linear(16, name="l2", input_from="c1")
    # an fc group takes no layer norm
    nbf = api.NetworkBuilder("bad_fc", input_hw=8, input_ch=3)
    nbf.fc(16, name="f1")
    with pytest.raises(ValueError, match="'ln'.*group head is a fc"):
        nbf.layernorm(name="ln")


@pytest.mark.parametrize("pool", ["maxpool", "avgpool"])
def test_a_conv_groups_layer_norm_cannot_follow_a_pool(pool):
    """conv -> pool -> layernorm is refused where it is wired, in the
    compiler and by the epilogue, as before conv groups took layer
    norms: no kernel pools and normalizes in one chain."""
    nb = api.NetworkBuilder("bad_pool", input_hw=8, input_ch=3)
    nb.conv(16, name="c1")
    getattr(nb, pool)(name="p1")
    with pytest.raises(ValueError, match="'ln'.*sequence FB but its group "
                       "head is a conv; gelu/layernorm/seqpool fuse onto "
                       "linear or attention group heads only$"):
        nb.layernorm(name="ln")
    ok = api.NetworkBuilder("ok", input_hw=8, input_ch=3)
    ok.conv(16, name="c1")
    ok.relu(name="r")
    ok.layernorm(name="ln")           # an activation may come before it
    layers = list(ok.build().layers)
    layers.insert(2, LayerSpec("p1", pool, out_ch=16, ksize=2,
                               stride=2, in_hw=8, out_hw=4))
    with pytest.raises(ValueError, match="'s layer norm cannot follow a "
                       "pool"):
        compile_network(layers, config=api.HurryConfig())
    y, scale, bias, res, gamma, beta = _operands(64, 16)
    with pytest.raises(ValueError, match=f"does not meet a {pool[:3]} pool"):
        fb_epilogue(y, scale, bias, gamma=gamma, beta=beta, norm="layer",
                    pool=pool[:3], window=2, img_hw=4)


def test_a_group_ending_in_a_pool_has_no_tap():
    """The tap is the value before a closing layer norm; a seq-mean after
    it leaves the group with its final buffer alone."""
    nb = api.NetworkBuilder("pooled", input_seq_dim=16)
    nb.linear(16, name="l1")
    r = nb.residual("input", name="r1")
    nb.layernorm(name="ln")
    nb.seqpool(name="pool")
    nb.fc(16, name="f")
    with pytest.raises(ValueError, match="'r1' is not a materialized"):
        nb.residual(r, name="r2")


# ---------------------------------------------------------------------------
# the compiled program
# ---------------------------------------------------------------------------

def test_program_taps_and_the_post_norm_nets_have_none():
    model = _small()[3]
    taps = model.program.taps()
    assert taps == {"patch": "patch", "b0_attn": "b0_res1",
                    "b0_fc2": "b0_res2", "b1_attn": "b1_res1"}
    assert "tap b0_res2" in model.program.summary()
    # at full size the layer norm's rows below the patch conv's GEMM
    # slice keep its 768-row K on mounts the 9-bit ADC cannot clip
    full = compile_network(api.vit_s16_graph(), config=api.HurryConfig())
    patch = full.stages()[0][0]
    assert patch.is_conv and patch.tile_rows == 512 - LN_ROWS
    assert not clip_possible(patch.tile_rows, 9)
    for net in ("vit_tiny", "resnet18"):
        assert compile_network(net, config=api.HurryConfig()).taps() == {}


def test_small_preset_equals_the_reference_bit_for_bit():
    cfg, params, x, model = _small()
    want = Reference(L.infer(cfg), cfg["hurry"], params).forward(x)
    got = model.run(x)
    assert torch.equal(got, want)
    assert got.shape == (3, 10)
    # and the functional interpreter through the crossbar model
    mm = make_crossbar_matmul(model.program.cfg)
    graph = small_graph()
    assert torch.equal(graph.forward(params, x, mm=mm), got)


def test_save_and_load_keep_the_taps(tmp_path):
    _, _, x, model = _small()
    loaded = api.load(model.save(str(tmp_path / "m.npz")), device="cpu")
    assert loaded.program.taps() == model.program.taps()
    assert torch.equal(loaded.run(x), model.run(x))
    assert torch.equal(loaded.run(x, logits=True), model.run(x, logits=True))


def test_taps_are_counted_planned_and_freed(monkeypatch):
    """``fb.tap_bytes`` counts the second stores, the ``stage`` spans and
    the plan name each stage's tap, and no buffer outlives its last
    reader (a tap lives from its stage to its residual's)."""
    _, _, x, model = _small(batch=2)
    program = model.program
    stages = program.stages()
    last = execute._last_reads(stages)
    held = []
    real = execute._static_stage

    def spy(gemm, posts, st, bufs, cfg, **kw):
        held.append((gemm.name, set(bufs)))
        return real(gemm, posts, st, bufs, cfg, **kw)

    monkeypatch.setattr(execute, "_static_stage", spy)
    trace.reset()
    trace.enable()
    try:
        plan = []
        execute.execute_packed(model.packed, x, plan=plan)
        spans = [s for s in trace.spans() if s.name == "stage"]
    finally:
        trace.disable()
    taps = program.taps()
    # 2 images x 16 tokens x 96 columns x 4 bytes, a tap
    assert trace.counters()[execute.TAP_BYTES] == len(taps) * 2 * 16 * 96 * 4
    assert [p.tap for p in plan] == [taps.get(g.name, "") for g, _ in stages]
    assert [s.attrs["tap"] for s in spans] == [p.tap for p in plan]
    index = {g.name: i for i, (g, _) in enumerate(stages)}
    for name, bufs in held:
        si = index[name]
        assert all(b == "input" or last.get(b, -1) >= si for b in bufs), \
            (name, bufs)
    # each tap is held from the stage after its own to its residual's
    for stage, tap in taps.items():
        live = [n for n, bufs in held if tap in bufs]
        assert live and index[live[0]] == index[stage] + 1
        assert index[live[-1]] == last[tap]


# ---------------------------------------------------------------------------
# the epilogue's second output
# ---------------------------------------------------------------------------

def _operands(M, N, seed=3):
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=g,
                      dtype=torch.int32)
    scale = torch.full((1, 1), 3.1e-6)
    bias, res = torch.randn(N, generator=g), torch.randn(M, N, generator=g)
    gamma, beta = torch.randn(N, generator=g), torch.randn(N, generator=g)
    return y, scale, bias, res, gamma, beta


@pytest.mark.parametrize("N", [384, 19])
def test_tap_is_the_sum_a_residual_stage_would_produce(N):
    y, scale, bias, res, gamma, beta = _operands(64, N)
    out, tap = fb_epilogue_ref(y, scale, bias, res, norm="layer",
                               gamma=gamma, beta=beta, tap=True)
    assert torch.equal(tap, fb_epilogue_ref(y, scale, bias, res))
    assert torch.equal(out, layer_norm_rows(tap, gamma, beta))
    assert torch.equal(out, fb_epilogue_ref(y, scale, bias, res,
                                            norm="layer", gamma=gamma,
                                            beta=beta))
    # the wrapper on a CPU tensor is the plain path
    got = fb_epilogue(y, scale, bias, res, norm="layer", gamma=gamma,
                      beta=beta, tap=True)
    assert torch.equal(got[0], out) and torch.equal(got[1], tap)


@pytest.mark.parametrize("kw", [dict(), dict(act="relu"), dict(softmax=True),
                                dict(norm="layer", pool="seqmean", window=8),
                                dict(norm="layer", heads=2)])
def test_a_tap_needs_a_layer_norm_and_no_pool_or_heads(kw):
    y, scale, bias, res, gamma, beta = _operands(64, 16)
    if "heads" in kw:
        y = y.reshape(4, 16, 16)
        scale = torch.full((4, 1, 1), 3.1e-6)
        res = bias = None
    with pytest.raises(ValueError, match="a tap stores the row"):
        fb_epilogue(y, scale, bias, res, gamma=gamma, beta=beta, tap=True,
                    **kw)
