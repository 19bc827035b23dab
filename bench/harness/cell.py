"""One run of one cell: set-up, the measured window, an optional traced
slice, then the check against the reference, as one result line.

Set-up (``setup_s``, from process start to the first timed batch):
the weights and the images from the seed on the device, ``api.compile``
(lowering and packing), one capture per key the cell's traffic uses
(``CompiledModel.warmup``), and the traffic's own warm pass.  The window
then runs the loop for ``seconds``.  After it, with ``trace``, a short
slice of the same loop runs under the profiler.  Then the program is
freed and the reference recomputes every answer the window produced.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from bench.counts import stages as counts
from bench.reference.hurry import Reference

from . import layers as L
from . import manifest, program, traffic
from .loops import Batches
from .trace import Trace, profile_slice

SLICE_BATCHES = 10          # batches in a traced slice (one test-set pass)


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads (``bench/metrics/<name>.py``)."""

    stats: dict
    setup: dict
    trace: Trace | None
    bound_s: dict           # least device seconds a forward, per wrapper
    macs: int               # multiply-accumulates an image


def _compare(pairs) -> dict:
    """The numbers compared, over every (program, reference) pair of
    answers (rows of class probabilities):

    * ``max_abs``: the largest absolute gap of a probability;
    * ``rel_l2``: the gap's 2-norm over the reference's;
    * ``logit_rel_l2``: the same of the logits the probabilities imply,
      ``ln p`` (floored at 1e-38) less its row mean, which a saturated
      softmax cannot hide;
    * ``logit_max``: the largest absolute gap of those logits.
    """
    acc = dict.fromkeys(("max_abs", "sq", "ref", "lsq", "lref",
                         "logit_max"), 0.0)
    for got, want in pairs:
        got, want = got.astype(np.float64), want.astype(np.float64)
        d = got - want
        if not np.all(np.isfinite(d)):
            return dict.fromkeys(("max_abs", "rel_l2", "logit_rel_l2",
                                  "logit_max"), math.inf)
        lg, lw = (np.log(np.maximum(v, 1e-38)) for v in (got, want))
        lg -= lg.mean(axis=-1, keepdims=True)
        lw -= lw.mean(axis=-1, keepdims=True)
        acc["max_abs"] = max(acc["max_abs"], float(np.abs(d).max()))
        acc["logit_max"] = max(acc["logit_max"],
                               float(np.abs(lg - lw).max()))
        acc["sq"] += float((d * d).sum())
        acc["ref"] += float((want * want).sum())
        acc["lsq"] += float(((lg - lw) ** 2).sum())
        acc["lref"] += float((lw * lw).sum())
    return {"max_abs": acc["max_abs"],
            "rel_l2": math.sqrt(acc["sq"] / acc["ref"]) if acc["ref"]
            else 0.0,
            "logit_rel_l2": math.sqrt(acc["lsq"] / acc["lref"])
            if acc["lref"] else 0.0,
            "logit_max": acc["logit_max"]}


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t0: float, device: torch.device, mix_overrides: dict | None = None,
        hurry_overrides: dict | None = None,
        stand_in: torch.dtype | None = None) -> tuple[dict, dict]:
    """One run; returns (the result line, every number compared or
    not).

    ``mix_overrides`` shrink the traffic for a test on the CPU;
    ``hurry_overrides`` run the program at other numerics than the
    reference, and ``stand_in`` puts the reference with its functional
    blocks stored in that type in the program's place in the check (the
    lower-precision controls, ``bench/control.py``).
    """
    man = manifest.manifest()
    c = manifest.cell(workload, man)
    cfg, mix = manifest.config(c["config"]), manifest.mix(c["traffic"])
    mix.update(mix_overrides or {})
    program_cfg = dict(cfg, hurry={**cfg["hurry"],
                                   **(hurry_overrides or {})})
    lim = manifest.limits(workload)
    layers = L.infer(cfg)
    cuda = device.type == "cuda"

    # -- set-up -----------------------------------------------------------
    gen = torch.Generator(device).manual_seed(seed)
    params = L.make_params(layers, cfg["init"], gen)
    images = traffic.test_set(mix, cfg, gen)
    model, compile_s = program.compile_model(program_cfg, params, device)
    for b in traffic.batch_sizes(mix):
        model.warmup(b)
    loop = Batches(model, images, mix)
    loop.warm()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    # -- the window -------------------------------------------------------
    stats = loop.run(deadline=time.perf_counter() + seconds)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = None
    if trace and cuda:
        def body():
            s = loop.run(units=SLICE_BATCHES)
            return s["units"], s["images"]
        tr = profile_slice(body, device)
    setup = {"compile_s": compile_s, "capture_s": program.capture_s(model)}
    rec = Run(stats, setup, tr, counts.bound_s(layers, mix["batch"]),
              counts.macs_per_image(layers))
    metrics = {}
    for m in manifest.end_to_end(workload, man) if not trace else []:
        v = _end_to_end(m["name"], stats, setup_s)
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    for m in manifest.per_layer(workload, man) if trace else []:
        v = manifest.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- the check, with the program freed --------------------------------
    answers = loop.answers
    loop.model = model = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(layers, cfg["hurry"], params)
    failed = stats["failed"]
    want, low = {}, {}
    for i in sorted({i for i, _ in answers}):
        x = images[i * mix["batch"]:(i + 1) * mix["batch"]]
        want[i] = ref.forward(x).cpu().numpy()
        if stand_in is not None:
            low[i] = Reference(layers, cfg["hurry"], params,
                               act=stand_in).forward(x).cpu().numpy()
    pairs = ([(low[i], want[i]) for i in want] if stand_in is not None
             else [(got, want[i]) for i, got in answers])
    numbers = _compare(pairs)
    compared = {k: {"value": v, "limit": lim[k]["limit"]}
                for k, v in numbers.items() if k in lim}
    correct = (failed == 0 and bool(pairs)
               and all(v["value"] <= v["limit"] for v in compared.values()))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": stats["attempted"],
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = compared
    return result, numbers


def _end_to_end(name: str, stats: dict, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name == "images_per_s":
        return stats["images"] / stats["seconds"]
    raise SystemExit(f"no end-to-end metric {name!r} in the harness")


def log_compared(compared: dict) -> None:
    """The numbers compared beside their limits, as the last lines of
    standard error."""
    for k, v in compared.items():
        print(f"compared {k} = {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
