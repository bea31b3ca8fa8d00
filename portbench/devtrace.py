"""The device trace of a traced window, read into the per-layer numbers.

`torch.profiler` (CPU and CUDA activities) records the window's first
stretch; its Chrome trace is written to a temporary file (under TMPDIR),
read back and deleted. From it:

- device operations: kernels, copies and fills, by start and duration;
- the phase each kernel works in, by the patterns of `kernels/*.json`
  (a kernel no file names is a torch operation of `api` or `core`);
- the busy time (the union of the device operations) and the traced
  window (first device operation's start to last one's end);
- the idle gaps between device operations, each named by the benchmark
  span (`portbench.*`) and the innermost CPU operation open on the host
  when the gap began.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass

from . import work as W

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def export(prof) -> dict:
    """The stopped profiler's Chrome trace as a dict."""
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


@dataclass
class Op:
    name: str
    ts: float     # us
    dur: float    # us

    @property
    def end(self) -> float:
        return self.ts + self.dur


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    return s.strip()[:120] or name[:120]


class Trace:
    def __init__(self, chrome: dict, rules: list, steps: int,
                 work_per_step: list):
        events = [e for e in chrome.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        self.device = sorted(
            (Op(e["name"], float(e["ts"]), float(e["dur"]))
             for e in events if e.get("cat") in DEVICE_CATS),
            key=lambda o: o.ts)
        self.host = sorted(
            (Op(e["name"], float(e["ts"]), float(e["dur"]))
             for e in events if e.get("cat") in ("user_annotation", "cpu_op")),
            key=lambda o: o.ts)
        self.steps = steps
        self.work_per_step = work_per_step
        self.phases_of = {}
        for op in self.device:
            if op.name not in self.phases_of:
                hit = set()
                for r in rules:
                    if r.pattern.search(op.name):
                        hit.update(r.phases)
                self.phases_of[op.name] = frozenset(hit)

    # the window and its busy time
    def window_us(self) -> float:
        if not self.device:
            return 0.0
        return max(o.end for o in self.device) - self.device[0].ts

    def busy_us(self) -> float:
        busy, end = 0.0, float("-inf")
        for o in self.device:
            if o.end > end:
                busy += o.end - max(o.ts, end)
                end = o.end
        return busy

    def gaps(self):
        """(start us, length us) of every stretch with no device operation
        between the first and the last."""
        out, end = [], None
        for o in self.device:
            if end is not None and o.ts > end:
                out.append((end, o.ts - end))
            end = o.end if end is None else max(end, o.end)
        return out

    # phases
    def torch_ops_us(self) -> float:
        return sum(o.dur for o in self.device if not self.phases_of[o.name])

    def group(self, phase: str) -> frozenset:
        """The phases merged with `phase` by the kernels that did its work
        in this trace: those linked through a kernel that does the work of
        several (empty where no kernel did it)."""
        sets = {p for p in self.phases_of.values() if p}
        group = set()
        frontier = {phase}
        while frontier:
            group |= frontier
            frontier = {q for s in sets if s & group for q in s} - group
        if not any(phase in s for s in sets):
            return frozenset()
        return frozenset(group)

    def roofline(self, phase: str) -> float | None:
        """Percent: the bound of the work of `phase` (merged as `group`
        says) over the device time of the kernels that did it, all steps
        of the trace; None where no kernel did it."""
        group = self.group(phase)
        if not group:
            return None
        t_us = sum(o.dur for o in self.device
                   if self.phases_of[o.name] & group)
        bound = sum(W.bound_ms(W.merge(w, group))[0]
                    for w in self.work_per_step) * self.steps
        return 100.0 * bound * 1e3 / t_us if t_us > 0 else None

    # what the breakdown shows
    def top_ops(self, n: int = 10) -> list:
        total = {}
        for o in self.device:
            k = short_name(o.name)
            total[k] = total.get(k, 0.0) + o.dur
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in top]

    def host_at(self, t: float) -> str:
        """The benchmark span and the innermost CPU operation open on the
        host at time t."""
        ours, inner = None, None
        for o in self.host:
            if o.ts > t:
                break
            if o.end >= t:
                if o.name.startswith("portbench."):
                    ours = o.name
                else:
                    inner = o.name
        name = ours or "no portbench span"
        return f"{name} > {inner}" if inner else name

    def top_gaps(self, n: int = 10) -> list:
        longest = sorted(self.gaps(), key=lambda g: -g[1])[:n]
        return [[self.host_at(t), d * 1e-6] for t, d in longest]
