"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from bench.harness import manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for word in MAN["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert (manifest.ROOT / MAN["command"][1]).is_file()


def test_names_units_and_lines():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + \
        MAN["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in MAN["configs"] + MAN["workloads"]:
        assert LINE.match(e["why"])
    for e in MAN["per_layer"]:
        assert LINE.match(e["layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = manifest.cell(cell)
    assert cell == f"{w['config']}.{w['traffic']}"
    cfg, mix = manifest.config(w["config"]), manifest.mix(w["traffic"])
    assert cfg["name"] == w["config"] and mix["loop"] == "batches"
    lim = manifest.limits(cell)
    assert lim and all(0 < v["limit"] < v["upper"] and v["limit"] >=
                       v["lower"] for v in lim.values())
    e2e = {m["name"] for m in manifest.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))


def test_configs_state_their_cuts():
    for c in MAN["configs"]:
        cfg = manifest.config(c["name"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
        assert {"layers", "hurry", "init", "assumed"} <= set(cfg)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_every_metric_file_is_named_in_the_manifest():
    named = {m["name"] for m in MAN["per_layer"]}
    files = {p.name[:-3] for p in (manifest.BENCH / "metrics").glob("*.py")}
    assert files == named
