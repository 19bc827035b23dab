"""Persist compiled models: ``CompiledModel.save`` / ``api.load``.

The port of ``repro.api.serialize``, writing and reading the same file:
a single ``.npz`` at format version 3, so a model saved by either
package loads in the other.

* ``__meta__`` — a JSON document holding the graph (name, input spec,
  ``LayerSpec`` list), the ``HurryConfig``, the batch-bucket ladder,
  and the compiled ``CrossbarProgram`` *minus its array plans*: net
  name, derived ``CrossbarConfig``, the full ``ProgramOp`` list (with
  ``MountRound`` weight slices and FB placements), buffer names, and
  the input spec.  The port's dataclasses keep the JAX package's field
  names and defaults, which is what makes the two sides' files one
  format.
* ``p0 .. pN`` — the parameter arrays, ordered by the ``params`` index
  in the meta document (``[layer, key]`` pairs).
* ``w{i}/wa{i}/wb{i}`` — the **packed weight planes** per GEMM stage in
  ``program.stages()`` order: the int8 mount-plane matrix, the f32
  weight ``amax`` and the f32 bias.  Dynamic-operand (attention) stages
  are 0-sized placeholders.
* ``wg{i}/wh{i}`` — the fused layer-norm FB's gamma/beta for the stages
  listed in the meta's ``ln_stages``.

A loaded model serves from the saved planes directly: loading neither
compiles nor quantizes.  The kernel-layout copy of each static stage's
planes (``PackedStage.wt``) is derived, so it is not saved; the loader
lays it out on the target device with ``pack.mount_stage``, as
``pack_program`` does.  Version-1 files (pre-packing) still load: the
planes are re-derived once from the saved params (repack fallback).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.workload import LayerSpec
from repro_torch.program.compile import (GEMM_OPS, CrossbarProgram,
                                         MountRound, ProgramOp)
from repro_torch.program.pack import (PackedProgram, PackedStage,
                                      mount_stage, pack_program)
from repro_torch.program.serve import BUCKETS, params_to

from .config import HurryConfig
from .graph import NetworkGraph

FORMAT = "repro.api/compiled-model"
VERSION = 3
_LOADABLE = (1, 2, 3)


def _program_meta(program: CrossbarProgram) -> dict:
    ops = []
    for op in program.ops:
        d = dataclasses.asdict(op)
        d["mount_rounds"] = [dataclasses.asdict(r)
                             for r in op.mount_rounds]
        ops.append(d)
    return {"net": program.net, "cfg": dataclasses.asdict(program.cfg),
            "ops": ops, "input": program.input, "output": program.output,
            "logits": program.logits, "in_hw": program.in_hw,
            "in_ch": program.in_ch, "in_features": program.in_features,
            "in_seq": program.in_seq}


def _program_from_meta(meta: dict) -> CrossbarProgram:
    ops = []
    for d in meta["ops"]:
        d = dict(d)
        d["mount_rounds"] = tuple(MountRound(**r)
                                  for r in d["mount_rounds"])
        ops.append(ProgramOp(**d))
    return CrossbarProgram(
        net=meta["net"], cfg=CrossbarConfig(**meta["cfg"]),
        ops=tuple(ops), plans=(), input=meta["input"],
        output=meta["output"], logits=meta["logits"],
        in_hw=meta["in_hw"], in_ch=meta["in_ch"],
        in_features=meta["in_features"], in_seq=meta.get("in_seq", 0))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_model(model, path: str) -> str:
    """Write ``model`` (a ``CompiledModel``) to ``path``; returns path."""
    g = model.graph
    index = []
    arrays = {}
    for layer in sorted(model.params):
        for key in sorted(model.params[layer]):
            arrays[f"p{len(index)}"] = _np(model.params[layer][key])
            index.append([layer, key])
    ln_stages = []
    for i, st in enumerate(model.packed.stages):
        arrays[f"w{i}"] = _np(st.w8)
        arrays[f"wa{i}"] = _np(st.w_amax)
        arrays[f"wb{i}"] = _np(st.bias)
        if st.ln_g is not None:
            ln_stages.append(i)
            arrays[f"wg{i}"] = _np(st.ln_g)
            arrays[f"wh{i}"] = _np(st.ln_b)
    meta = {
        "format": FORMAT, "version": VERSION,
        "graph": {"name": g.name, "in_hw": g.in_hw, "in_ch": g.in_ch,
                  "in_features": g.in_features, "in_seq": g.in_seq,
                  "layers": [dataclasses.asdict(l) for l in g.layers]},
        "config": dataclasses.asdict(model.config),
        "program": _program_meta(model.program),
        "params": index,
        "packed_stages": len(model.packed.stages),
        "ln_stages": ln_stages,
        "buckets": list(model.buckets),
    }
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return path


def _stage(gemm: ProgramOp, arrays: dict, cfg: CrossbarConfig,
           device: torch.device) -> PackedStage:
    """One saved stage on ``device``, its kernel-layout weight laid out
    as ``pack_program`` lays it (dynamic stages have none)."""
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    wt = None
    if gemm.kind != "dyn_gemm":
        wt = mount_stage(gemm, t["w8"], cfg.adc_bits)
    return PackedStage(wt=wt, **t)


def load_model(path: str, *, device: torch.device):
    """Load a ``CompiledModel`` saved by ``save_model`` (or by the JAX
    package) onto ``device`` — no compile step, and (version >= 2) no
    weight quantization: the packed planes are read back verbatim.  The
    model starts with no executable: on a GPU its first ``run`` of each
    key captures one, as a freshly compiled model's does."""
    from .model import CompiledModel
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"][()]))
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} file")
        version = meta.get("version")
        if version not in _LOADABLE:
            raise ValueError(f"{path}: format version {version} not in "
                             f"supported {_LOADABLE}")
        params: dict = {}
        for i, (layer, key) in enumerate(meta["params"]):
            params.setdefault(layer, {})[key] = z[f"p{i}"]
        ln = set(meta.get("ln_stages", ()))
        saved = [dict(w8=z[f"w{i}"], w_amax=z[f"wa{i}"], bias=z[f"wb{i}"],
                      **({"ln_g": z[f"wg{i}"], "ln_b": z[f"wh{i}"]}
                         if i in ln else {}))
                 for i in range(meta.get("packed_stages", 0))]
    params = params_to(params, device)
    program = _program_from_meta(meta["program"])
    if version == 1:   # pre-packing save: re-derive planes once, now
        packed = pack_program(program, params)
    else:
        n_gemm = sum(1 for op in program.ops if op.kind in GEMM_OPS)
        if len(saved) != n_gemm:
            raise ValueError(f"{path}: corrupt file — {len(saved)} packed "
                             f"weight planes for {n_gemm} GEMM stages")
        packed = PackedProgram(
            stages=tuple(_stage(gemm, arrays, program.cfg, device)
                         for (gemm, _), arrays in zip(program.stages(),
                                                      saved)),
            program=program)
    gm = meta["graph"]
    graph = NetworkGraph(
        name=gm["name"], in_hw=gm["in_hw"], in_ch=gm["in_ch"],
        in_features=gm["in_features"], in_seq=gm.get("in_seq", 0),
        layers=tuple(LayerSpec(**d) for d in gm["layers"]))
    return CompiledModel(graph=graph, config=HurryConfig(**meta["config"]),
                         program=program, params=params, packed=packed,
                         device=device,
                         buckets=tuple(meta.get("buckets", BUCKETS)))
