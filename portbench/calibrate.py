"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...
        --control-seeds 101,102,... [--seconds 2]

Each seed is one run of the cell by `harness.run_cell`, the path that
decides `correct` in the benchmark's runs, with a short window: for each
of --seeds the program's, and for each of --control-seeds the control's
(`reference.control`, the reference at the next precision below the
configuration's, in the program's place). One line of JSON a run, with
its compared numbers and `correct`; then the lower reading of `err` (the
largest of the program's runs) and the upper one (the smallest of the
control's), beside the limit the configuration holds. Exits 1 where a
program run is not correct or a control run is. The benchmark's own runs
do not run this; it sets and re-checks the limits in `configs/`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from portbench import harness, reference, spec  # noqa: E402


def readings(root: Path, cell_name: str, seeds, control_seeds,
             seconds: float = 2.0, device: str = "cuda", gemm=None,
             settle_seconds: float = harness.SETTLE_SECONDS):
    """([{"seed", "side", "correct", "err", "nonfinite", "s"}], config)
    for the program's seeds and the control's, one run of the cell each."""
    bench = spec.load(root)
    cfg = spec.config(root, bench, spec.cell(bench, cell_name)["config"])
    control = reference.control_gemm(cfg["check"]["control"])
    out = []
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t = time.time()
            result, checks, _ = harness.run_cell(
                root, cell_name, seed, seconds, False, t, device=device,
                gemm=gemm if side == "program" else control,
                settle_seconds=settle_seconds)
            out.append({"seed": seed, "side": side,
                        "correct": result["correct"],
                        **{name: v for name, v, _ in checks},
                        "s": time.time() - t})
    return out, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    problem = harness.card_problem(1)
    if problem:
        print(f"[calibrate] {problem}", file=sys.stderr)
        return 1
    harness.clear_switches()
    rows, cfg = readings(ROOT, args.workload,
                         [int(s) for s in args.seeds.split(",")],
                         [int(s) for s in args.control_seeds.split(",")],
                         args.seconds)
    for r in rows:
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    prog = [r for r in rows if r["side"] == "program"]
    ctrl = [r for r in rows if r["side"] == "control"]
    print(json.dumps({"workload": args.workload,
                      "lower": max((r["err"] for r in prog), default=None),
                      "upper": min((r["err"] for r in ctrl), default=None),
                      "limit": cfg["check"]["err"]}))
    sound = all(r["correct"] for r in prog) and not any(
        r["correct"] for r in ctrl)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
