"""Readings for the correctness limits of a cell, on the card.

    python3 bench/control.py --workload vit_tiny.eval_b1024 \
        --seeds 12 --controls w7a7,bf16 --control-seeds 3 --seconds 2 \
        --first 7000001

Runs the cell's own loop for a short window on each of ``--seeds`` seeds
as the program stands (the sound readings, whose largest is a limit's
lower reading), then on ``--control-seeds`` seeds under each control of
``--controls`` (whose smallest reading is an upper one), all in one
process.  The controls (``CONTROLS``) are the lower precisions next to
what the configuration states: the program's own narrower integer
widths for its 8-bit weights and inputs, and the reference with its
float32 functional blocks stored in bfloat16, put in the program's
place.  Each run prints one JSON line: the seed, the kind, ``correct``
under the current limits, and the numbers compared.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

# name -> cell.run's keywords; "bf16" is filled in once torch is loaded
CONTROLS = {
    "w7a7": {"hurry_overrides": {"weight_bits": 7, "input_bits": 7}},
    "w8a7": {"hurry_overrides": {"input_bits": 7}},
    "w7a8": {"hurry_overrides": {"weight_bits": 7}},
    "w6a6": {"hurry_overrides": {"weight_bits": 6, "input_bits": 6}},
    "w4a4": {"hurry_overrides": {"weight_bits": 4, "input_bits": 4}},
    "bf16": {"stand_in": "bfloat16"},
}


def control(name: str) -> dict:
    """``cell.run``'s keywords for the control ``name``."""
    import torch

    kw = dict(CONTROLS[name])
    if "stand_in" in kw:
        kw["stand_in"] = getattr(torch, kw["stand_in"])
    return kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", default="w7a7,bf16")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from bench.harness import cell
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runs = [("sound", args.first + i, {}) for i in range(args.seeds)]
    for j, name in enumerate(filter(None, args.controls.split(","))):
        runs += [(name, args.first + 1000 * (j + 1) + i, control(name))
                 for i in range(args.control_seeds)]
    for kind, seed, kw in runs:
        t = time.perf_counter()
        res, numbers = cell.run(args.workload, seed, args.seconds, False,
                                t0=t, device=dev, **kw)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "correct": res["correct"],
                          "numbers": numbers,
                          "metrics": {k: v["value"] for k, v
                                      in res["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
