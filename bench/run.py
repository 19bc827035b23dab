"""Run one benchmark cell once and print its result as one JSON line.

    python3 bench/run.py --workload resnet18.eval_b1024 --seed 7 \
        --seconds 10 --trace 0

Drives ``repro_torch`` (the PyTorch and CUDA package) on one GPU; never
imports the JAX package.  Exits non-zero without a result when no GPU
(or fewer than the cell asks for) is visible, or when ``jax``,
``jaxlib``, ``flax`` or ``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    import torch

    from bench.harness import cell, manifest

    want = manifest.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < want:
        print(f"{args.workload} needs {want} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, _ = cell.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), t0=T0, device=device)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark drives the port "
              "alone", file=sys.stderr)
        return 3
    cell.log_compared(result["compared"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
