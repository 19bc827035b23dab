"""ViT-S/16's configuration: the yardstick's counts against hand counts,
its layer list against the port's own graph, and the plain reference
against the port's CPU path on one full-width image."""

import torch

from bench.counts import stages as C
from bench.harness import layers as L
from bench.harness import manifest, program
from bench.reference.hurry import Reference

CFG = manifest.config("vit_s16")

# counted by hand from the published widths, per image: the patch conv
# 196 x 768 x 384; a block's qkv 196 x 384 x 1152, scores and context 6
# heads of 196 x 64 x 196, projection 196 x 384 x 384, MLP 2 x 196 x 384
# x 1536; the head 384 x 1000
HAND_MACS = (196 * 768 * 384
             + 12 * (196 * 384 * 1152 + 2 * 6 * 196 * 64 * 196
                     + 196 * 384 * 384 + 2 * 196 * 384 * 1536)
             + 384 * 1000)
# patch, per block two layer norms, qkv and projection, the MLP; the
# final layer norm and the head
HAND_PARAMS = (16 * 16 * 3 * 384 + 384
               + 12 * (2 * 2 * 384 + 384 * 1152 + 1152 + 384 * 384 + 384
                       + 384 * 1536 + 1536 + 1536 * 384 + 384)
               + 2 * 384 + 384 * 1000 + 1000)


def test_macs_parameters_and_stages_match_the_hand_counts():
    layers = L.infer(CFG)
    assert HAND_MACS == C.macs_per_image(layers) == 4_574_026_752
    assert HAND_PARAMS == L.n_params(layers) == CFG["parameters"] \
        == 21_974_632
    st = C.stages(layers)
    assert (len(st), sum(s.right_in > 0 for s in st)) == (74, 24)
    ks = {s.name: s.K for s in st}
    assert ks["patch"] == 768 and ks["b0_attn@ctx"] == 196
    assert ks["b0_attn@scores"] == 64 and ks["b0_fc2"] == 1536


def test_layer_list_builds_the_zoo_graph():
    from repro_torch.api import zoo
    want = zoo.vit_s16_graph()
    got = program.graph(CFG)
    assert got.layers == want.layers
    assert (got.in_hw, got.in_ch) == (want.in_hw, want.in_ch) == (224, 3)


def test_reference_equals_the_port_on_one_full_width_image():
    layers = L.infer(CFG)
    gen = torch.Generator().manual_seed(2**31 + 27)
    params = L.make_params(layers, CFG["init"], gen)
    x = L.make_images(1, CFG, gen)
    model, _ = program.compile_model(CFG, params, torch.device("cpu"))
    got = model.run(x)
    want = Reference(layers, CFG["hurry"], params).forward(x)
    assert torch.equal(got, want)
    assert got.shape == (1, 1000)
