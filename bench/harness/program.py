"""The system under test: a configuration's layer list as the port's graph.

The only module of the harness that imports the program (``repro_torch``,
never the JAX package).  ``graph`` replays the layer list through the
port's ``NetworkBuilder``, one builder call per layer, so a new
configuration is a data file and no code.
"""

from __future__ import annotations

import time

import torch

from repro_torch import api


def graph(config: dict) -> "api.NetworkGraph":
    nb = api.NetworkBuilder(config["name"], input_hw=config["image_size"],
                            input_ch=config["num_channels"])
    for spec in config["layers"]:
        kind, name = spec["kind"], spec["name"]
        src = {"input_from": spec["input"]} if "input" in spec else {}
        if kind == "conv":
            nb.conv(spec["out"], k=spec["k"], stride=spec["stride"],
                    padding=spec["pad"], name=name, **src)
        elif kind in ("fc", "linear"):
            getattr(nb, kind)(spec["out"], name=name, **src)
        elif kind == "attention":
            nb.attention(spec["heads"], name=name, **src)
        elif kind in ("maxpool", "avgpool"):
            getattr(nb, kind)(k=spec["k"], stride=spec["stride"], name=name)
        elif kind == "residual":
            nb.residual(spec["source"], name=name)
        else:
            getattr(nb, kind)(name=name)
    return nb.build()


def compile_model(config: dict, params: dict, device: torch.device
                  ) -> tuple["api.CompiledModel", float]:
    """``api.compile`` of the configuration on ``params`` (lowering and
    packing), and the host seconds it took."""
    t0 = time.perf_counter()
    model = api.compile(graph(config), api.HurryConfig(**config["hurry"]),
                        params=params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model, time.perf_counter() - t0


def capture_s(model) -> float:
    """Host seconds the model's executables took to warm up and capture
    (the program's own ``Executable.capture_s``, summed over keys)."""
    return sum(fn.capture_s for fn in model._fns.values())

