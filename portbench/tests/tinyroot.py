"""A checkout in miniature for the benchmark's CPU tests: BENCHMARK.json
and a copy of the benchmark's folder, with every configuration cut to a
size the CPU's plain versions run in a moment."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = ("dgemm14-square8192", "cgemm8-square8192")


def make(tmp: Path, size: int = 48) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["m"] = cfg["n"] = cfg["k"] = size
        path.write_text(json.dumps(cfg))
    return root


def config(root: Path, cell: str) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())
