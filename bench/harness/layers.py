"""A configuration's layer list, read as data: shapes and parameters.

A configuration file (``bench/configs/<name>.json``) lists the network
layer by layer: ``{"name", "kind", ...}`` with ``out``/``k``/``stride``/
``pad`` for a conv, ``out`` for an fc or a linear, ``heads`` for an
attention, ``k``/``stride`` for a pool, ``source`` for a residual, and
``input`` where a layer reads another layer's output than the one
before it.  This module infers every layer's shape from that list alone
(no code of the program), so the reference, the operation counts and
the weights all read the same description.
"""

from __future__ import annotations

import dataclasses
import math

import torch

GEMM_KINDS = ("conv", "fc", "linear", "attention")


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer with its inferred shapes.

    ``shape_in``/``shape_out`` are ``("spatial", hw, ch)``, ``("seq",
    T, D)`` or ``("flat", F)``, per image.
    """

    name: str
    kind: str
    src: str
    shape_in: tuple
    shape_out: tuple
    spec: dict


def tokens(shape: tuple) -> tuple:
    if shape[0] == "spatial":
        return ("seq", shape[1] * shape[1], shape[2])
    if shape[0] != "seq":
        raise ValueError(f"not a token shape: {shape}")
    return shape


def flat(shape: tuple) -> int:
    if shape[0] == "spatial":
        return shape[1] * shape[1] * shape[2]
    if shape[0] == "flat":
        return shape[1]
    raise ValueError(f"no flat view of {shape}")


def infer(config: dict) -> list[Layer]:
    """The configuration's layers with their per-image shapes."""
    shapes = {"input": ("spatial", config["image_size"],
                        config["num_channels"])}
    prev = "input"
    out = []
    for spec in config["layers"]:
        kind, name = spec["kind"], spec["name"]
        src = spec.get("input") or prev
        s = shapes[src]
        if kind == "conv":
            k, st, p = spec["k"], spec["stride"], spec["pad"]
            hw = (s[1] + 2 * p - k) // st + 1
            o = ("spatial", hw, spec["out"])
        elif kind == "fc":
            o = ("flat", spec["out"])
        elif kind == "linear":
            t = tokens(s)
            o = ("seq", t[1], spec["out"])
        elif kind in ("attention", "layernorm"):
            o = tokens(s)
        elif kind in ("relu", "gelu", "softmax", "residual"):
            o = s
        elif kind in ("maxpool", "avgpool"):
            if spec["k"] != spec["stride"]:
                raise ValueError(f"{name}: only window == stride pools")
            o = ("spatial", s[1] // spec["stride"], s[2])
        elif kind == "seqpool":
            o = ("flat", tokens(s)[2])
        else:
            raise ValueError(f"{name}: unknown layer kind {kind!r}")
        shapes[name] = o
        out.append(Layer(name, kind, src, s, o, spec))
        prev = name
    return out


def covered(n: int, k: int, s: int, p: int) -> list[int]:
    """Indices along one axis of a conv's input that some window reads
    (a 1x1 stride-2 conv reads every other one)."""
    out = (n + 2 * p - k) // s + 1
    return sorted({o * s - p + i for o in range(out) for i in range(k)
                   if 0 <= o * s - p + i < n})


def param_shapes(layers: list[Layer]) -> dict[str, dict[str, tuple]]:
    """``{layer: {key: shape}}`` in the program's layouts: conv weights
    (k, k, in_ch, out_ch), fc and linear (in, out), attention ``wqkv``
    (D, 3D), ``bqkv``, ``wo`` (D, D), ``bo``; layer norm ``g``, ``b``."""
    out: dict = {}
    for l in layers:
        sp = l.spec
        if l.kind == "conv":
            out[l.name] = {"w": (sp["k"], sp["k"], l.shape_in[2], sp["out"]),
                           "b": (sp["out"],)}
        elif l.kind == "fc":
            out[l.name] = {"w": (flat(l.shape_in), sp["out"]),
                           "b": (sp["out"],)}
        elif l.kind == "linear":
            out[l.name] = {"w": (tokens(l.shape_in)[2], sp["out"]),
                           "b": (sp["out"],)}
        elif l.kind == "attention":
            d = tokens(l.shape_in)[2]
            out[l.name] = {"wqkv": (d, 3 * d), "bqkv": (3 * d,),
                           "wo": (d, d), "bo": (d,)}
        elif l.kind == "layernorm":
            d = l.shape_out[2]
            out[l.name] = {"g": (d,), "b": (d,)}
    return out


def n_params(layers: list[Layer]) -> int:
    return sum(math.prod(s) for p in param_shapes(layers).values()
               for s in p.values())


def make_params(layers: list[Layer], init: dict, generator: torch.Generator
                ) -> dict[str, dict[str, torch.Tensor]]:
    """Float32 weights on the generator's device, from one draw.

    ``init`` (the configuration's): GEMM weights normal with std
    ``weights`` (a number) or He's sqrt(2 / fan_in) (``"he"``; fan_in the
    product of all but the last axis), biases normal with std
    ``bias_std``, layer-norm gains ``1 + N(0, norm_std^2)`` and shifts
    ``N(0, norm_std^2)``: one ``randn`` for all of them, then views of
    it, each scaled in place.
    """
    shapes = param_shapes(layers)
    total = sum(math.prod(s) for p in shapes.values() for s in p.values())
    flat = torch.randn(total, generator=generator, device=generator.device)
    kinds = {l.name: l.kind for l in layers}
    params: dict = {}
    off = 0
    for lname, p in shapes.items():
        params[lname] = {}
        for key, shape in p.items():
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if kinds[lname] == "layernorm":
                t.mul_(init["norm_std"])
                if key == "g":
                    t.add_(1.0)
            elif len(shape) == 1:
                t.mul_(init["bias_std"])
            elif init["weights"] == "he":
                t.mul_(math.sqrt(2.0 / math.prod(shape[:-1])))
            else:
                t.mul_(float(init["weights"]))
            params[lname][key] = t
    return params


def make_images(n: int, config: dict, generator: torch.Generator
                ) -> torch.Tensor:
    """``n`` NHWC float32 images, standard normal, on the generator's
    device."""
    hw, ch = config["image_size"], config["num_channels"]
    return torch.randn(n, hw, hw, ch, generator=generator,
                       device=generator.device)
