"""The one traffic generator: a mix file (``bench/traffic/<mix>.json``)
in, the cell's work out, the same for the same seed.

One loop kind, ``batches``: an offline pass over a test set of
``test_set`` images, made on the device from the seed, cut into whole
batches of ``batch`` and sent in order, again and again from the start,
``in_flight`` batches enqueued ahead of the host (``loops.Batches``).
"""

from __future__ import annotations

import torch

from . import layers as L

LOOPS = ("batches",)


def check(mix: dict) -> None:
    if mix["loop"] not in LOOPS:
        raise SystemExit(f"no loop {mix['loop']!r} in the harness")
    if mix["test_set"] % mix["batch"]:
        raise SystemExit("a test set is sent in whole batches")


def test_set(mix: dict, config: dict, generator: torch.Generator
             ) -> torch.Tensor:
    """The mix's test set of the configuration's images, from the seed."""
    check(mix)
    return L.make_images(mix["test_set"], config, generator)


def batch_sizes(mix: dict) -> list[int]:
    """The batch sizes a mix sends, each once (the keys to warm up)."""
    check(mix)
    return [mix["batch"]]
