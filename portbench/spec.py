"""Finds the benchmark's files by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one kernel sits in a file of its own, under the
benchmark's folder of the checkout `root`:

    BENCHMARK.json                 the cells, the metrics, each config's file
    portbench/configs/<c>.json     a deployment: precision, moduli, shapes,
                                   the limits its outputs are held to
    portbench/traffic/<t>.json     a mix of calls, read by `gen.py`
    portbench/metrics/<name>.py    a per-layer metric's reader, `read(ctx)`
    portbench/kernels/<k>.json     a kernel-name pattern and its phases

A new cell, mix, metric or kernel is a new file and a new entry; no file
that is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HARNESS = "portbench"


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> dict:
    return json.loads(
        (Path(root) / HARNESS / "traffic" / f"{name}.json").read_text())


def metrics_of(spec: dict, cell_name: str, table: str) -> list:
    """The entries of `table` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads key, and those that list it."""
    return [m for m in spec[table]
            if cell_name in m.get("workloads", [cell_name])]


def reader(root: Path, name: str):
    """The `read(ctx)` function of metric `name`'s reader file."""
    path = Path(root) / HARNESS / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"{HARNESS}_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclass(frozen=True)
class KernelRule:
    """Device kernels whose name matches `pattern` (a regular expression,
    searched) do the work of `phases`."""
    name: str
    pattern: re.Pattern
    phases: tuple


def kernel_rules(root: Path) -> list:
    rules = []
    for path in sorted((Path(root) / HARNESS / "kernels").glob("*.json")):
        d = json.loads(path.read_text())
        rules.append(KernelRule(path.stem, re.compile(d["pattern"]),
                                tuple(d["phases"])))
    return rules
