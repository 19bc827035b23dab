"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` and ``bench/limits/<cell>.json``; a
per-layer metric ``<name>`` is read by ``bench/metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, man: dict | None = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def mix(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())


def end_to_end(cell_name: str, man: dict | None = None) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    man = man or manifest()
    return [m for m in man["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(cell_name: str, man: dict | None = None) -> list[dict]:
    """The per-layer metrics a cell reports: those listing it, and those
    without a list whose end-to-end metric it reports."""
    man = man or manifest()
    mine = {m["name"] for m in end_to_end(cell_name, man)}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"]
                                  in mine else [])]


def reader(metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
