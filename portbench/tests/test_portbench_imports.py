"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

from portbench.tests import tinyroot

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    assert not top_level_imports(path) & set(harness.JAX_NAMES)


def test_the_reference_imports_only_torch():
    assert top_level_imports(BENCH / "reference.py") == {"__future__", "torch"}


def test_whole_names_are_compared():
    mods = {"gemmul8_tpu_torch": 0, "gemmul8_tpu_torch.api": 0,
            "jaxtyping": 0, "jax_free": 0, "torch": 0}
    assert harness.loaded_jax(mods) == []
    mods.update({"jax": 0, "jaxlib.xla_client": 0, "flax.linen": 0,
                 "gemmul8_tpu.core.gemm": 0})
    assert harness.loaded_jax(mods) == ["flax.linen", "gemmul8_tpu.core.gemm",
                                        "jax", "jaxlib.xla_client"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of each cell (on the CPU, tiny) in a fresh process, then
    the modules it loaded."""
    root = tinyroot.make(tmp_path)
    code = (
        "import json, sys, time\n"
        f"sys.path[0:0] = [{str(tinyroot.REPO)!r}]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"for cell in {list(tinyroot.CELLS)!r}:\n"
        f"    r, _, _ = harness.run_cell(Path({str(root)!r}), cell, 3, 0.1,"
        " False, time.time(), device='cpu',"
        " settle_seconds=0.05)\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(harness.loaded_jax()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_no_card_no_result(tmp_path):
    """Without a card, run.py exits nonzero and prints no result line."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         tinyroot.CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_unknown_cell_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_json_names_every_file():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
