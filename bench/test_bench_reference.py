"""The plain reference against the port's CPU path, on the same weights
and images: both compute the same roundings there, so they agree bit for
bit."""

import pytest
import torch

from bench.harness import layers as L
from bench.harness import manifest, program
from bench.reference.hurry import Reference


@pytest.mark.parametrize("name", ["resnet18", "vit_tiny"])
def test_reference_equals_the_port_on_the_cpu(name):
    cfg = manifest.config(name)
    layers = L.infer(cfg)
    gen = torch.Generator().manual_seed(2**31 + 11)
    params = L.make_params(layers, cfg["init"], gen)
    x = L.make_images(2, cfg, gen)
    model, _ = program.compile_model(cfg, params, torch.device("cpu"))
    got = model.run(x)
    want = Reference(layers, cfg["hurry"], params).forward(x)
    assert torch.equal(got, want)
    assert got.shape == (2, cfg["num_classes"])
    low = Reference(layers, cfg["hurry"], params,
                    act=torch.bfloat16).forward(x)
    assert not torch.equal(low, want)


def test_reference_refuses_an_adc_that_can_clip():
    cfg = manifest.config("resnet18")
    layers = L.infer(cfg)
    params = L.make_params(layers, cfg["init"],
                           torch.Generator().manual_seed(1))
    ref = Reference(layers, dict(cfg["hurry"], adc_bits=5), params)
    with pytest.raises(NotImplementedError):
        ref.forward(L.make_images(1, cfg, torch.Generator().manual_seed(2)))
