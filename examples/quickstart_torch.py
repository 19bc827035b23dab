"""Quickstart: the ``repro_torch.api`` front door, end to end, on the GPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--net alexnet] \\
        [--batch 2] [--device cpu]

The PyTorch/CUDA port's counterpart of ``examples/quickstart.py``.  One
network definition drives everything:

  1. get a graph: a paper CNN or ``vit_tiny`` from ``api.zoo``, or a
     custom ``NetworkBuilder`` program (``--net custom``);
  2. ``api.compile`` it under one ``HurryConfig`` into a
     ``CompiledModel`` on the device (the GPU unless ``--device`` names
     another; without a GPU it raises);
  3. ``.simulate()`` the paper's headline comparison (HURRY against
     ISAAC/MISCA cycles, energy, area, utilization; host only);
  4. ``.run()`` it numerically, on a GPU through the ``crossbar_gemm``
     and ``fb_epilogue`` CUDA kernels, and check it bit for bit against
     the functional crossbar forward under the clip-free config;
  5. ``.save()`` / ``api.load()`` it and check that the loaded model,
     which never touches the compiler, serves the same bits.

``vit-tiny`` on a GPU: the kernel's GELU, layer norm and softmax round
in another order than the plain versions that ``graph.forward`` uses,
so the two are not bit-exact there; the check prints the flag and holds
the gap to ``SEQ_REL`` (relative logits) and ``SEQ_PROB_ATOL``
(probabilities) instead.  On the CPU every net must be bit-exact.
``main(argv)`` returns the numbers it prints.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import api, trace
from repro_torch.api import HurryConfig, NetworkBuilder
from repro_torch.device import resolve_device
from repro_torch.models.cnn import make_crossbar_matmul

NETS = ["alexnet", "vgg16", "resnet18", "vit-tiny", "custom"]
# vit-tiny on a GPU against the functional forward: the tolerances that
# chip_smoke.py holds vit_tiny's card-against-CPU logits and
# probabilities to
SEQ_REL = 1e-2
SEQ_PROB_ATOL = 1e-3


def custom_graph():
    """A user-defined net: the builder is not limited to the paper CNNs."""
    nb = NetworkBuilder("custom", input_hw=16, input_ch=8)
    nb.conv(32, name="c1")
    r1 = nb.relu(name="r1")
    proj = nb.conv(48, k=1, padding=0, name="proj", input_from=r1)
    nb.conv(48, name="c2", input_from=r1)
    nb.residual(proj, name="res")
    nb.relu(name="r2")
    nb.maxpool(name="p1")
    nb.fc(10, name="fc")
    nb.softmax(name="softmax")
    return nb.build()


def sim_table(model: api.CompiledModel) -> str:
    """The simulate comparison as ``examples/quickstart.py`` prints it."""
    reports = {name: model.simulate(arch)
               for name, arch in [("HURRY", "hurry"),
                                  ("ISAAC-128", "isaac-128"),
                                  ("ISAAC-256", "isaac-256"),
                                  ("ISAAC-512", "isaac-512"),
                                  ("MISCA", "misca")]}
    lines = [f"{'arch':10s} {'cycles':>10s} {'energy uJ':>10s} "
             f"{'area mm2':>9s} {'spatial':>8s} {'temporal':>9s}"]
    for name, r in reports.items():
        lines.append(f"{name:10s} {r.throughput_cycles:10.0f} "
                     f"{r.energy_pj / 1e6:10.2f} {r.area_mm2:9.2f} "
                     f"{r.spatial_utilization:8.2%} "
                     f"{r.temporal_utilization:9.2%}")
    h, i = reports["HURRY"], reports["ISAAC-128"]
    lines.append(f"\nHURRY vs ISAAC-128:  speedup "
                 f"{i.throughput_cycles / h.throughput_cycles:.2f}x"
                 f"  energy-eff {i.energy_pj / h.energy_pj:.2f}x"
                 f"  area-eff {h.area_efficiency / i.area_efficiency:.2f}x")
    lines.append("paper claims:        speedup 1.21-3.35x | energy 2.66-5.72x "
                 "| area 2.98-7.91x (across nets/baselines)")
    return "\n".join(lines)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="alexnet", choices=NETS)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else dev)
    # one config for chip geometry, crossbar numerics, and the executor;
    # 511 rows keeps every ADC read clip-free, so the compiled program is
    # bit-exact against the functional model
    config = HurryConfig(array_rows=511)
    network = {"custom": custom_graph, "vit-tiny": "vit_tiny"}.get(
        args.net, args.net)
    if callable(network):
        network = network()
    model = api.compile(network, config, device=dev)
    graph = model.graph
    is_seq = args.net == "vit-tiny"
    out = dict(net=args.net, device=str(dev), batch=args.batch,
               stages=len(model.program.stages()))

    print(f"=== {graph.name} (int8, one 16-tile chip) ===")
    print(model.summary())

    if is_seq:
        # the analytical chip model does not cover dynamic-operand mounts
        print(f"\n=== analytical simulation ({graph.name}): n/a for "
              "sequence workloads ===")
    else:
        print(f"\n=== analytical simulation ({graph.name}) ===")
        out["sim"] = sim_table(model)
        print(out["sim"])

    print(f"\n=== compiled-program inference ({graph.name}) ===")
    x = torch.randn(graph.input_shape(args.batch),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    model.warmup(args.batch, logits=True)     # builds, captures the graph
    launched = trace.counters()
    t0 = time.perf_counter()
    y_prog = model.run(x, logits=True)        # a replay: no warm-up in it
    _sync(dev)
    us = (time.perf_counter() - t0) * 1e6
    counted = trace.counters()
    out["launches"] = {w: counted.get(f"launches.{w}", 0)
                       - launched.get(f"launches.{w}", 0)
                       for w in ("crossbar_gemm", "fb_epilogue")}
    mm = make_crossbar_matmul(config.crossbar())
    y_fn = graph.forward(model.params, x, mm=mm, logits=True)
    exact = torch.equal(y_fn, y_prog)
    agree = (y_fn.argmax(1) == y_prog.argmax(1)).float().mean().item()
    rel = ((y_prog - y_fn).abs().max() / y_fn.abs().max()).item()
    print(f"model.run vs functional crossbar forward: bit-exact={exact}  "
          f"argmax-agree={agree:.0%}  steady-state {us:.0f} us/batch"
          f"{args.batch}")
    out.update(exact=exact, agree=agree, rel=rel, us=us)
    held = exact
    if is_seq:
        gap = model.run(x) - graph.forward(model.params, x, mm=mm)
        out["prob_gap"] = gap.abs().max().item()
    if is_seq and dev.type == "cuda":
        held = rel <= SEQ_REL and out["prob_gap"] <= SEQ_PROB_ATOL
        print(f"  on {dev.type}: the kernel's GELU / layer norm / softmax "
              f"round in another order; max rel logit gap {rel:.2e} (limit "
              f"{SEQ_REL}), max |probs gap| {out['prob_gap']:.2e} (limit "
              f"{SEQ_PROB_ATOL})")

    print(f"\n=== save / load ({graph.name}) ===")
    with tempfile.TemporaryDirectory() as d:
        path = model.save(os.path.join(d, f"{graph.name}.npz"))
        kb = os.path.getsize(path) / 1024
        loaded = api.load(path, device=dev)   # no compiler involved
        y_loaded = loaded.run(x, logits=True)
        roundtrip = torch.equal(y_prog, y_loaded)
        print(f"saved {kb:.0f} KiB -> loaded model bit-exact={roundtrip}")
    out.update(roundtrip=roundtrip, kib=kb)

    if not (held and roundtrip):
        raise SystemExit("bit-exactness check failed")
    return out


if __name__ == "__main__":
    main()
