"""Mesh dry-run: trace one rank's step of every (arch x shape x mesh) cell.

The port of ``repro.launch.dryrun``.  Where the JAX package lowers and
compiles each cell on 512 host devices, this traces rank 0's program of
a 256-rank (16x16) or 512-rank (2x16x16) world: torch's ``"fake"``
process-group backend stands in for the cluster (collectives return at
once) and ``FakeTensorMode`` for the memory (no tensor holds data).  For
each cell it builds the step (``train_step`` with remat and
``auto_microbatches`` for train shapes, ``prefill_step`` /
``serve_step`` for inference shapes), distributes the parameters,
optimizer state, batch and caches as DTensors by ``ShardingRules``, runs
the step once under the rules with ``launch.cost.Counter`` entered,
constrains the outputs to their specs (JAX's ``out_shardings``), and
records ``trace_s`` (host seconds of the traced step), the memory
(argument, output and peak bytes per device), the roofline terms, the
model FLOPs and the useful-FLOPs ratio.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]

``--device`` names the fake tensors' device (default ``cuda``, which
needs a GPU present; ``cpu`` runs anywhere).  Artifacts go to
``artifacts/dryrun_torch/``; ``python -m repro_torch.launch.roofline``
tabulates them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import cost
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.models import lm
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import context as shctx
from repro_torch.sharding.rules import P, ShardingRules, distribute
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import make_train_step

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip per "
                       "DESIGN.md §6)")
    return True, ""


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    """A cell's shape cut for a reduced config: 1/2048 of the sequence
    (at least 16 tokens; 256 for long_500k) and 1/8 of the batch (a small
    mesh's data axis divides it where the production one divides the
    full batch), the kind unchanged."""
    return dataclasses.replace(shape, seq_len=max(16, shape.seq_len // 2048),
                               global_batch=max(1, shape.global_batch // 8))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                multi_pod: bool = False, model_size: int = 16,
                data_size: int = 16, device="cuda"):
    """Stand-in inputs (global tensors; call under ``FakeTensorMode``)
    and partition specs for one cell."""
    rules = ShardingRules(cfg, model_size=model_size, data_size=data_size,
                          multi_pod=multi_pod)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)
    pspecs = rules.param_specs(params)
    B, S = shape.global_batch, shape.seq_len

    def tok(b, s):
        return torch.zeros((b, s), dtype=torch.int32, device=device)

    def frames(dtype):
        return torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                           device=device)

    if shape.kind == "train":
        batch = {"tokens": tok(B, S)}
        bspecs = {"tokens": rules.tokens_spec(B)}
        if cfg.is_encdec:
            batch["frames"] = frames(torch.float32)
            bspecs["frames"] = rules.encoder_spec()
        opt = init_opt_state(params)
        ospecs = {"m": pspecs, "v": pspecs, "step": P()}
        metric_specs = {"grad_norm": P(), "lr": P(), "loss": P()}
        return {"args": (params, opt, batch),
                "specs": (pspecs, ospecs, bspecs),
                "out_specs": (pspecs, ospecs, metric_specs),
                "rules": rules}
    if shape.kind == "prefill":
        args = [params, tok(B, S)]
        specs = [pspecs, rules.tokens_spec(B)]
        if cfg.is_encdec:
            args.append(frames(torch.float32))
            specs.append(rules.encoder_spec())
        lsp = rules.logits_spec(B)
        out = P(lsp[0], lsp[2])          # (B, V) last-position logits
        return {"args": tuple(args), "specs": tuple(specs),
                "out_specs": out, "rules": rules}
    # decode: one token against a cache/state of seq_len
    caches = lm.init_caches(cfg, B, S, device=device)
    cspecs = rules.cache_specs(caches, B)
    bshard = rules.tokens_spec(B)
    args = [params, tok(B, 1), caches,
            torch.zeros((), dtype=torch.int32, device=device)]
    specs = [pspecs, bshard, cspecs, P()]
    if cfg.is_encdec:
        args.append(frames(torch.bfloat16))
        specs.append(rules.encoder_spec())
    out_specs = (bshard, rules.logits_spec(B), cspecs)
    return {"args": tuple(args), "specs": tuple(specs),
            "out_specs": out_specs, "rules": rules}


def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      data_size: int = 16, budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor so per-device saved activations
    (one residual per layer under remat) fit the budget."""
    b_local = max(1, shape.global_batch // data_size)
    saved = cfg.n_layers * b_local * shape.seq_len * cfg.d_model * 2
    if cfg.n_experts:
        # MoE dispatch/expert buffers add ~capacity_factor * top_k copies
        saved *= (1 + 1.25 * cfg.experts_per_token / 2)
    need = max(1, int(-(-saved // budget_bytes)))
    mb = 1
    while mb < need and mb < 16 and shape.global_batch % (mb * 2) == 0:
        mb *= 2
    return mb


def build_step(cfg: ModelConfig, shape: ShapeConfig, rules=None):
    if shape.kind == "train":
        lspec = rules.logits_spec() if rules is not None else None
        mb = auto_microbatches(cfg, shape)
        return make_train_step(cfg, remat=True, logits_spec=lspec,
                               microbatches=mb)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tuples/lists/dicts and its specs."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in specs}
    return type(specs)(_map_specs(fn, t, s) for t, s in zip(tree, specs))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in cost._tensors(tree):
        t = t._local_tensor if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _trace(cfg, shape, mesh, multi_pod: bool, device):
    """One traced step on this rank's blocks (under ``FakeTensorMode``):
    its seconds, argument and output bytes, and roofline terms."""
    spec = input_specs(cfg, shape, multi_pod=multi_pod,
                       model_size=mesh.size(-1),
                       data_size=mesh.size(mesh.ndim - 2), device=device)
    rules = spec["rules"]
    rules.mesh = mesh      # enables the sequence-sharded decode
    step = build_step(cfg, shape, rules)
    args = _map_specs(lambda t, s: distribute(t, s, mesh), spec["args"],
                      spec["specs"])
    counter = cost.Counter()
    arg_bytes = counter.track(args)
    t0 = time.perf_counter()
    with counter, shctx.use_rules(rules):
        out = step(*args)
        out = _map_specs(shctx.constrain, out, spec["out_specs"])
    trace_s = time.perf_counter() - t0
    return trace_s, arg_bytes, _local_bytes(out), counter.roofline()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             save: bool = True, mesh_shape: tuple | None = None,
             reduced: bool = False, device="cuda") -> dict:
    """One cell on rank 0 of a fake world of ``mesh_shape`` (default the
    production mesh: (16, 16), or (2, 16, 16) with ``multi_pod``).
    ``reduced`` takes the arch's ``reduced()`` config and
    ``reduced_shape``.  A cell that raises is recorded as ``"error"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), reduced_shape(shape)
    ok, why = cell_supported(cfg, shape)
    label = f"{arch}/{shape_name}/{'multipod' if multi_pod else 'singlepod'}"
    if not ok:
        result = {"cell": label, "status": "skipped", "reason": why}
        _emit(result, save)
        return result

    prod_shape, axes = production_shape(multi_pod)
    mesh_shape = tuple(mesh_shape or prod_shape)
    n_dev = math.prod(mesh_shape)
    try:
        with fake_world(n_dev):
            # the mesh's rank map is a real tensor: made before fake mode
            mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=axes)
            with FakeTensorMode():
                trace_s, arg_bytes, out_bytes, roof = _trace(
                    cfg, shape, mesh, multi_pod, device)
        mf = cost.model_flops(cfg, shape)
        result = {
            "cell": label, "status": "ok",
            "trace_s": round(trace_s, 1),
            "n_devices": n_dev,
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(0, int(roof.peak_bytes_per_device)
                                  - arg_bytes - out_bytes),
                "peak_bytes_per_device": roof.peak_bytes_per_device,
            },
            "roofline": roof.as_dict(),
            "model_flops_global": mf,
            "model_flops_per_device": mf / n_dev,
            "useful_flops_ratio": (mf / n_dev) / max(roof.flops, 1.0),
        }
    except Exception as e:   # a failed cell is a bug — record it loudly
        result = {"cell": label, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
    _emit(result, save)
    return result


def _emit(result: dict, save: bool):
    line = {k: v for k, v in result.items() if k != "traceback"}
    print(json.dumps(line), flush=True)
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        name = result["cell"].replace("/", "__") + ".json"
        (ARTIFACTS / name).write_text(json.dumps(result, indent=1))


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default cuda)")
    args = ap.parse_args(argv)

    if args.all:
        n_ok = n_skip = n_err = 0
        for arch in ARCH_IDS:
            for shape in SHAPES:
                r = run_cell(arch, shape, multi_pod=args.multi_pod,
                             device=args.device)
                n_ok += r["status"] == "ok"
                n_skip += r["status"] == "skipped"
                n_err += r["status"] == "error"
        print(f"# dry-run summary: ok={n_ok} skipped={n_skip} errors={n_err}")
        raise SystemExit(1 if n_err else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    r = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                 device=args.device)
    raise SystemExit(0 if r["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
