"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""
import json
import re

import pytest

from benchmark import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = [m["name"] for m in BENCH["end_to_end"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))
    ms = E2E + [m["name"] for m in BENCH["per_layer"]]
    assert len(ms) == len(set(ms))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    """Each cell's file names its configuration, entry and check table;
    each of its metrics has a reader; it reports setup_s, another
    end-to-end metric and a per-layer one, each of those moving an
    end-to-end metric the cell reports."""
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    wl = manifest.workload(cell)
    assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg["file"] == f"benchmark/configs/{w['config']}.json"
    assert manifest.config(w["config"])["name"] == w["config"]
    mod = manifest.entry(wl["entry"])
    assert hasattr(mod, "Entry") and mod.LIBS
    assert wl["check"] and all(
        s["how"] in ("rel", "group", "exact") for s in wl["check"].values())
    e2e = [m["name"] for m in manifest.cell_metrics(BENCH, cell, False)]
    per = manifest.cell_metrics(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e
    for name in e2e + [m["name"] for m in per]:
        if name != "setup_s":
            assert callable(manifest.metric(name).read)


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_four_chip_cells():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
