"""The yardstick's counts against hand counts, and the configurations'
layer lists against the port's own graphs of the same networks."""

import pytest

from bench.counts import stages as C
from bench.harness import layers as L
from bench.harness import manifest, program

# multiply-accumulates an image, counted by hand from the layer shapes
HAND_MACS = {"resnet18": 555_422_720, "vit_tiny": 359_204_736}
PARAMS = {"resnet18": 11_169_162, "vit_tiny": 5_349_706}
STAGES = {"resnet18": (21, 0), "vit_tiny": (74, 24)}


@pytest.mark.parametrize("name", sorted(HAND_MACS))
def test_macs_and_parameters_match_the_hand_counts(name):
    layers = L.infer(manifest.config(name))
    assert C.macs_per_image(layers) == HAND_MACS[name]
    assert L.n_params(layers) == PARAMS[name]
    assert manifest.config(name)["parameters"] == PARAMS[name]
    st = C.stages(layers)
    assert (len(st), sum(s.right_in > 0 for s in st)) == STAGES[name]


@pytest.mark.parametrize("name", sorted(HAND_MACS))
def test_counts_use_the_logical_k(name):
    """A conv's K is k * k * in_ch and a linear's its features, never a
    padded width."""
    layers = L.infer(manifest.config(name))
    ks = {s.name: s.K for s in C.stages(layers)}
    if name == "resnet18":
        assert ks["conv0"] == 27 and ks["s3b1_conv2"] == 4608
        assert ks["s1b0_proj"] == 64
    else:
        assert ks["b0_fc2"] == 768 and ks["patch"] == 48
        assert ks["b0_attn@scores"] == 64 and ks["b0_attn@ctx"] == 64


def test_bytes_of_one_stage_by_hand():
    """vit_tiny's first scores stage over 2 images: 6 slices of
    (64, 64) x (64, 64)."""
    layers = L.infer(manifest.config("vit_tiny"))
    s = next(s for s in C.stages(layers) if s.name == "b0_attn@scores")
    by = C.stage_bytes(s, 2)
    S, e = 6, 64 * 64
    assert by["quantize_layout"] == (4 * e * S + e * S + 4 * S
                                     + 4 * e * S + e * S + 12 * S)
    assert by["crossbar_gemm"] == e * S + e * S + 4 * e * S
    assert by["fb_epilogue"] == 4 * e * S + 4 * S + 4 * e * S
    b = C.bound_s(layers, 1024)
    assert all(v > 0 for v in b.values())


@pytest.mark.parametrize("name", sorted(HAND_MACS))
def test_layer_list_builds_the_zoo_graph(name):
    from repro_torch.api import zoo
    want = (zoo.resnet18_graph() if name == "resnet18"
            else zoo.vit_tiny_graph(depth=12))
    got = program.graph(manifest.config(name))
    assert got.layers == want.layers
    assert (got.in_hw, got.in_ch) == (want.in_hw, want.in_ch)
