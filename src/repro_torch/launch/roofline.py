"""Roofline aggregation: artifacts/dryrun_torch/*.json -> the roofline table.

The port of ``repro.launch.roofline``:

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh singlepod]
                                                         [--markdown]

Per (arch x shape) on one mesh: the compute/memory/collective terms
(seconds, from ``launch.cost``'s H100 data-sheet constants: a model of
an H100 cluster, not a measurement), the dominant term, MODEL_FLOPS
against the counted flops ("useful ratio" — catches remat and
replication waste), peak bytes per device and whether they fit one
H100's 80 GB, and with ``--hints`` a one-line "what would move the
dominant term".
"""

from __future__ import annotations

import argparse
import json
import pathlib

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")
DEVICE_GB = 80          # one H100's memory

HINTS = {
    ("collective", "train"): "overlap grad reduce-scatter with bwd compute; "
                             "shard MoE experts (EP) to cut TP all-reduces",
    ("collective", "decode"): "sequence-sharded flash decode: all-reduce "
                              "partial softmax stats instead of gathering KV",
    ("collective", "prefill"): "ring-attention over seq shards; fuse QKV "
                               "all-gathers",
    ("memory", "train"): "fuse epilogues (a fused GEMM kernel); bf16 "
                         "master-weight cast; larger attention chunks",
    ("memory", "decode"): "quantize KV cache to int8; fuse cache update "
                          "into the attention kernel",
    ("memory", "prefill"): "flash-attention kernel (no score "
                           "materialization); fuse norms into GEMMs",
    ("compute", "train"): "reduce remat recompute (policy: save attn "
                          "outputs); causal-block skip in attention",
    ("compute", "decode"): "batch more sequences per step",
    ("compute", "prefill"): "causal-block skip: compute only the lower-"
                            "triangular score blocks",
}


def load(mesh: str = "singlepod"):
    rows = []
    for f in sorted(ARTIFACTS.glob(f"*__{mesh}.json")):
        rows.append(json.loads(f.read_text()))
    return rows


def kind_of(cell: str) -> str:
    if "train" in cell:
        return "train"
    if "prefill" in cell:
        return "prefill"
    return "decode"


def fmt_table(rows, markdown=False):
    out = []
    hdr = ["cell", "cmp_s", "mem_s", "coll_s", "bound", "useful",
           "peak_GB", f"fit{DEVICE_GB}G"]
    if markdown:
        out.append("| " + " | ".join(hdr) + " |")
        out.append("|" + "---|" * len(hdr))
    else:
        out.append(f"{'cell':42s} {'cmp_s':>8s} {'mem_s':>8s} {'coll_s':>8s} "
                   f"{'bound':>10s} {'useful':>6s} {'peakGB':>7s} fit")
    for d in rows:
        cell = d["cell"].rsplit("/", 1)[0]
        if d["status"] == "skipped":
            line = [cell, "-", "-", "-", "skipped", "-", "-", "-"]
        elif d["status"] == "error":
            line = [cell, "-", "-", "-", "ERROR", "-", "-", "-"]
        else:
            r = d["roofline"]
            peak = d["memory"]["peak_bytes_per_device"] / 1e9
            line = [cell, f"{r['compute_s']:.3f}", f"{r['memory_s']:.3f}",
                    f"{r['collective_s']:.3f}", r["bottleneck"],
                    f"{d['useful_flops_ratio']:.2f}", f"{peak:.1f}",
                    "yes" if peak <= DEVICE_GB else "NO"]
        if markdown:
            out.append("| " + " | ".join(line) + " |")
        else:
            out.append(f"{line[0]:42s} {line[1]:>8s} {line[2]:>8s} "
                       f"{line[3]:>8s} {line[4]:>10s} {line[5]:>6s} "
                       f"{line[6]:>7s} {line[7]}")
    return "\n".join(out)


def hint_for(d) -> str:
    if d["status"] != "ok":
        return ""
    return HINTS.get((d["roofline"]["bottleneck"], kind_of(d["cell"])), "")


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="singlepod",
                    choices=["singlepod", "multipod"])
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--hints", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.mesh)
    if not rows:
        raise SystemExit(f"no artifacts for mesh={args.mesh} in {ARTIFACTS}; "
                         "run python -m repro_torch.launch.dryrun first")
    print(fmt_table(rows, args.markdown))
    if args.hints:
        print()
        for d in rows:
            h = hint_for(d)
            if h:
                print(f"{d['cell'].rsplit('/', 1)[0]:42s} -> {h}")


if __name__ == "__main__":
    main()
