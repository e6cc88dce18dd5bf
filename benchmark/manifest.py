"""The benchmark's data and how the harness finds it by name:

  BENCHMARK.json                   metrics, bounds, cells (at the root)
  benchmark/workloads/<cell>.json  a cell: its configuration, entry and
                                   traffic parameters, the numbers that
                                   decide `correct` and their limits
  benchmark/configs/<config>.json  a configuration: the program's preset
                                   and its whole `sim` tree as run
  benchmark/entries/<entry>.py     one module a kind of entry
  benchmark/metrics/<metric>.py    one reader a metric, `read(run)`

A later cell, configuration or metric is a new file of these; nothing in
the harness names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark(root: Path | None = None) -> dict:
    with open((root or ROOT) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, here: Path | None = None) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    return _json((here or HERE) / "workloads" / f"{name}.json")


def config(name: str, here: Path | None = None) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a configuration name: {name!r}")
    return _json((here or HERE) / "configs" / f"{name}.json")


def entry(name: str):
    """The entry module `benchmark/entries/<name>.py`."""
    if not NAME.match(name) or name.startswith("_"):
        raise ValueError(f"not an entry name: {name!r}")
    return importlib.import_module(f"{__package__}.entries.{name}")


def metric(name: str, here: Path | None = None):
    """The reader module `benchmark/metrics/<name>.py` (a metric's name may
    hold dots, so it is loaded from its path)."""
    if not NAME.match(name):
        raise ValueError(f"not a metric name: {name!r}")
    path = (here or HERE) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.m_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a cell reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with a `workloads` key only in
    the cells it lists. setup_s is the harness's own."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if cell in m.get("workloads", [cell])]
