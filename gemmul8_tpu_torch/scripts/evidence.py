"""Regenerate the port's evidence: counterpart of `scripts/run_evidence.sh`.

    python -m gemmul8_tpu_torch.scripts.evidence [cpu|card|all]

  cpu   the CPU accuracy protocols (`accuracy_sweep all --device cpu`;
        hours at the reference's sizes), weak scaling on gloo CPU ranks,
        and `pytest tests/test_torch_*.py`;
  card  `time_sweep 4096,8192 all`, `accuracy_sweep all` and
        `scale_bench` (its defaults, 16384^3) on the card.

Each step runs in its own process, from the repository root, and runs
even if an earlier one failed, as in the shell script. At the end the
driver names every failed step and exits nonzero if there was one: a
failure is never swallowed. The card steps need a card: without one they
count as one failed step. CSVs land in `results_torch/`; plot them with
`python scripts/plot_results.py results_torch/oz2_results_*.csv` where
matplotlib is installed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def _module(name: str, *args: str):
    return [sys.executable, "-m", f"gemmul8_tpu_torch.scripts.{name}", *args]


def steps(mode: str):
    """[(name, argv)] of `mode`'s steps, in order."""
    out = []
    if mode in ("cpu", "all"):
        tests = sorted(str(p.relative_to(ROOT))
                       for p in (ROOT / "tests").glob("test_torch_*.py"))
        out += [
            ("accuracy_sweep all --device cpu",
             _module("accuracy_sweep", "all", "--device", "cpu")),
            ("weak_scaling --device cpu",
             _module("weak_scaling", "--device", "cpu")),
            ("pytest tests/test_torch_*.py",
             [sys.executable, "-m", "pytest", "-q", *tests]),
        ]
    if mode in ("card", "all"):
        out += [
            ("time_sweep 4096,8192 all",
             _module("time_sweep", "4096,8192", "all")),
            ("accuracy_sweep all", _module("accuracy_sweep", "all")),
            ("scale_bench", _module("scale_bench")),
        ]
    return out


def main(argv=None):
    """Run the steps; returns the names of the failed ones (exits 1 if
    there is one)."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.evidence")
    ap.add_argument("mode", nargs="?", default="all",
                    choices=["cpu", "card", "all"])
    args = ap.parse_args(argv)
    import torch

    plan = steps(args.mode)
    failed = []
    if args.mode != "cpu" and not torch.cuda.is_available():
        print("!! no CUDA device (torch.cuda.is_available() is false): the "
              "card steps cannot run", flush=True)
        failed.append("the card steps (no CUDA device)")
        plan = steps("cpu") if args.mode == "all" else []
    for name, cmd in plan:
        print(f"== {name}", flush=True)
        if subprocess.run(cmd, cwd=ROOT).returncode != 0:
            print(f"!! step failed (continuing): {name}", flush=True)
            failed.append(name)
    if failed:
        print("evidence: failed steps: " + "; ".join(failed),
              file=sys.stderr, flush=True)
        sys.exit(1)
    print(f"evidence {args.mode}: every step passed", flush=True)
    return failed


if __name__ == "__main__":
    main()
