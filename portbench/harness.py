"""One run of one cell: set-up, the timed window, the judgement, the line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (`setup_s`, from the process's start to the window's): imports,
the CUDA context, the program's kernel library (built on a checkout's
first run, in its `build/kernels/`), the operands from the seed, one call
of every shape of the step, and SETTLE_SECONDS of the mix's own steps, so
that the window starts at the clock the card holds under load (the card
falls from its boost clock to the 700 W cap's within a second).

The window drives `gemmul8_tpu_torch.gemm` as a user calls it, with the
configuration's moduli and mode and everything else at its default (the
program's GEMMUL8_* switches are cleared from the environment), IN_FLIGHT
steps dispatched ahead of the one the device runs. With
`--trace 1` the profiler records the window's first half, up to
TRACE_SECONDS; the per-layer metrics are read from that trace, from the
untraced rest's host spans, and from the program's launch counter.

The outputs of one step drawn from the seed, and of the last step, are
judged after the window, once the memory peak is read and the rest is
freed, against `reference.py` (`correct`); the compared numbers are
printed beside their limits as the last lines of standard error and
under "checks", the last key of the result line, which is the last line
of standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

JAX_NAMES = ("jax", "jaxlib", "flax", "gemmul8_tpu")
PROGRAM = "gemmul8_tpu_torch"
CAPABILITY = (9, 0)
# the traced stretch: the window's first half, at most this many seconds
TRACE_SECONDS = 5.0
# steps queued ahead: the device never waits on a host that dispatches a
# step faster than the device runs one, and the host never waits for room
# in CUDA's launch queue inside a call (an unbounded loop fills it)
IN_FLIGHT = 2
SETTLE_SECONDS = 3.0


def loaded_jax(modules=None) -> list:
    """The loaded modules whose top-level name is one of JAX_NAMES, whole
    (`gemmul8_tpu_torch` is not `gemmul8_tpu`)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in JAX_NAMES)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_problem(chips: int) -> str | None:
    """Why this machine cannot run a cell on `chips` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards; "
                f"{torch.cuda.device_count()} present")
    cap = torch.cuda.get_device_capability(0)
    if cap != CAPABILITY:
        return (f"{torch.cuda.get_device_name(0)} has compute capability "
                f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a")
    return None


def clear_switches() -> None:
    for key in [k for k in os.environ if k.startswith("GEMMUL8_")]:
        del os.environ[key]


def keep_index(seed: int, seconds: float, step_s: float) -> int:
    """The step whose outputs are judged beside the last one: drawn from
    the seed in the window's first 60%, by the steps the settle stretch
    ran per second."""
    frac = random.Random(seed).uniform(0.05, 0.6)
    return int(frac * seconds / max(step_s, 1e-9))


def judge(plan, judged: list, limits: dict):
    """The compared numbers [(name, value, limit)] of the judged steps'
    outputs (one list of a step's outputs each, in the order of
    `plan.calls`) against the reference."""
    from . import reference

    err, nonfinite = 0.0, 0
    for j, c in enumerate(plan.calls):
        e, nf = reference.errors(c.a, c.b, c.alpha, c.beta, c.c,
                                 [outs[j] for outs in judged])
        err = e if e != e else max(err, e)   # NaN stays NaN
        nonfinite += nf
        if err != err:
            break
    return [("err", err, float(limits["err"])),
            ("nonfinite", float(nonfinite), float(limits["nonfinite"]))]


def held_bytes(tensors) -> int:
    """Bytes of device memory the tensors hold."""
    return sum(t.untyped_storage().nbytes() for t in tensors)


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, t0: float, device: str = "cuda", gemm=None,
             settle_seconds: float = SETTLE_SECONDS):
    """(result, checks, notes): the result line's dict, the compared
    numbers [(name, value, limit)] and the lines printed before the
    result. `gemm` stands in for the program's (the control, tests)."""
    import torch

    from . import devtrace, gen, power, spec, window

    bench = spec.load(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(root, bench, cell["config"])
    mix = spec.traffic(root, cell["traffic"])
    on_card = device == "cuda"
    program = None
    if gemm is None:
        import importlib

        program = importlib.import_module(PROGRAM)
        gemm = program.gemm
    t_program = time.time()
    plan = gen.make_plan(cfg, mix, seed, device)

    def step():
        return [gemm(c.a, c.b, alpha=c.alpha, beta=c.beta, c=c.c,
                     num_moduli=plan.num_moduli, fastmode=plan.fastmode)
                for c in plan.calls]

    clock = window.CudaClock() if on_card else window.HostClock()
    clock.sync()
    t_plan = time.time()
    step()                 # every shape of the step; builds the kernels
    clock.sync()
    t_first = time.time()
    sampler = power.ClockSampler() if on_card else contextlib.nullcontext()
    with sampler:
        settle = window.run(step, settle_seconds, IN_FLIGHT, clock)
        del settle.kept, settle.last
        step_s = settle.span_s / max(len(settle.step_ms), 1)
        launches = launch_counter(program)
        if launches is not None:
            launches.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = devtrace.start() if trace else None
        setup_s = time.time() - t0
        t_open = time.time()
        win = window.run(step, seconds, IN_FLIGHT, clock,
                         keep_at=keep_index(seed, seconds, step_s),
                         annotate=trace,
                         trace_seconds=min(seconds / 2, TRACE_SECONDS)
                         if trace else None,
                         stop_trace=prof.stop if trace else None)
        t_close = time.time()
    steps = len(win.step_ms)
    device_peak = clock.peak()
    # the caller's workspace: the benchmark's own hold on the judged
    # step's outputs left out
    peak = device_peak
    if win.kept is not None:
        peak = max(win.peak_at_keep, device_peak - held_bytes(win.kept))
    n_launches = sum(launches.values()) if launches is not None else None
    tr = None
    if trace:
        tr = devtrace.Trace(devtrace.export(prof), spec.kernel_rules(root),
                            win.traced_steps, plan.work_per_step)
        del prof
    judged = [win.last] + ([win.kept] if win.kept is not None else [])
    del win.kept, win.last
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = judge(plan, judged, cfg["check"])
    ref_s = time.perf_counter() - t_ref
    ok = all(v <= lim for _, v, lim in checks)

    ctx = SimpleNamespace(
        steps=steps, window=win, plan=plan, setup_s=setup_s,
        peak_bytes=peak, launches=n_launches, trace=tr)
    table = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, table):
        value = spec.reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(device_peak)}
    result = {"correct": ok, "attempted": steps * len(plan.calls),
              "failed": 0 if ok else len(judged) * len(plan.calls),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = tr.window_us() * 1e-6
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.top_gaps()}
    result["checks"] = {name: {"value": finite_or_none(v), "limit": lim}
                        for name, v, lim in checks}
    notes = [
        f"card: {power.card_line() if on_card else 'cpu'}",
        "clock over the window: " + (sampler.summary(t_open, t_close)
                                     if on_card else "not sampled"),
        f"window: {steps} steps, device span {win.span_s:.6f} s"
        + (f", {win.traced_steps} traced" if trace else ""),
        f"set-up: {t_program - t0:.3f} s to the program's import, operands "
        f"{t_plan - t_program:.3f} s, first call {t_first - t_plan:.3f} s, "
        f"settle and the rest {t_open - t_first:.3f} s",
        f"judged: {len(judged)} steps' outputs, reference {ref_s:.3f} s",
        f"memory: device peak {device_peak} bytes, workspace peak {peak} "
        f"bytes (the judged step's outputs left out)",
    ]
    return result, checks, notes


def launch_counter(program):
    """The program's kernel-launch counter (hopper.build.LAUNCHES), or
    None where it has none."""
    if program is None:
        return None
    try:
        from gemmul8_tpu_torch.hopper import build
    except ImportError:
        return None
    return getattr(build, "LAUNCHES", None)


def finite_or_none(x: float):
    """x for the result line, which is JSON: None where x is not finite."""
    return x if x == x and abs(x) != float("inf") else None


def main(argv, t0: float, root: Path) -> int:
    args = parse(argv)
    from . import spec

    try:
        cell = spec.cell(spec.load(root), args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"[portbench] {exc}", file=sys.stderr)
        return 2
    problem = card_problem(int(cell["chips"]))
    if problem:
        print(f"[portbench] {problem}; the benchmark runs only on a card",
              file=sys.stderr)
        return 1
    clear_switches()
    result, checks, notes = run_cell(root, args.workload, args.seed,
                                     args.seconds, bool(args.trace), t0)
    found = loaded_jax()
    if found:
        print(f"[portbench] JAX modules loaded in the benchmark's process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for line in notes:
        print(line)
    for name, value, limit in checks:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
