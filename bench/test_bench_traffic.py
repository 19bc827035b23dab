"""The traffic generator: the same work for the same seed, in whole
batches, and only the loops the harness has."""

import pytest
import torch

from bench.harness import manifest, traffic
from bench.harness.loops import Batches

SEEDS = [0, 7, 2**31 + 5, 2**33 + 1]
CFG = manifest.config("resnet18")
SMALL = dict(manifest.mix("eval_b1024"), batch=2, test_set=6)


@pytest.mark.parametrize("seed", SEEDS)
def test_test_set_repeats_for_a_seed(seed):
    a, b = (traffic.test_set(SMALL, CFG, torch.Generator().manual_seed(seed))
            for _ in range(2))
    assert torch.equal(a, b)
    assert a.shape == (6, CFG["image_size"], CFG["image_size"],
                       CFG["num_channels"])


def test_seeds_change_the_images_not_the_sizes():
    sets = [traffic.test_set(SMALL, CFG, torch.Generator().manual_seed(s))
            for s in SEEDS]
    assert len({tuple(s.shape) for s in sets}) == 1
    assert not torch.equal(sets[0], sets[1])


def test_batch_sizes_are_the_keys():
    assert traffic.batch_sizes(manifest.mix("eval_b1024")) == [1024]


@pytest.mark.parametrize("bad", [{"loop": "requests"}, {"test_set": 7}])
def test_a_mix_the_harness_cannot_send_is_refused(bad):
    with pytest.raises(SystemExit):
        traffic.batch_sizes(dict(SMALL, **bad))


def test_batches_go_in_order_and_wrap():
    class Echo:
        def run(self, x):
            return x[:, 0, 0, :1].clone()

    images = traffic.test_set(SMALL, CFG, torch.Generator().manual_seed(3))
    loop = Batches(Echo(), images, SMALL)
    stats = loop.run(units=5)
    assert [i for i, _ in loop.answers] == [0, 1, 2, 0, 1]
    assert stats["images"] == stats["attempted"] == 5 * SMALL["batch"]
    for i, got in loop.answers:
        assert (got == images[2 * i:2 * i + 2, 0, 0, :1].numpy()).all()
