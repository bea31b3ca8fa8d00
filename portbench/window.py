"""The timed window: steps dispatched back to back, a mark after each.

Before step i is dispatched, the host waits until step i - in_flight has
ended on the device (an event, not a synchronisation of the device), so
`in_flight` steps are queued at most: the device never waits while the
host dispatches a step in less time than the device runs one, and the
host's own time in each call (`host_ms`) is its work, not a wait for room
in the launch queue. The device is synchronised once, after the last
step. Step i's time is the time between the marks after steps i - 1 and
i (a mark before step 0 opens the window): on the card CUDA events, on
the CPU (tests only) the host clock.

A traced window stops its profiler at the first step that ends past
`trace_seconds` (the device synchronised first, so the trace holds whole
steps) and runs on untraced to the end; the host spans of the untraced
steps are the ones without the profiler's cost.

The host drops each step's outputs before it dispatches the next, but
keeps those of step `keep_at` to the end for the judgement; `peak()` is
read just before they are kept, so that the harness can leave them out
of the window's memory peak.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch


class CudaClock:
    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark):
        mark.synchronize()

    def sync(self):
        torch.cuda.synchronize()

    def elapsed_ms(self, m0, m1) -> float:
        return m0.elapsed_time(m1)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated()


class HostClock:
    """The CPU's stand-in, where every call has ended when it returns."""

    def mark(self):
        return time.perf_counter()

    def wait(self, mark):
        pass

    def sync(self):
        pass

    def elapsed_ms(self, m0, m1) -> float:
        return (m1 - m0) * 1e3

    def peak(self) -> int:
        return 0


@dataclass
class Window:
    step_ms: list          # every step's time, in order
    host_ms: list          # the host's time in each step's calls
    span_s: float          # first mark to last
    kept: list | None      # outputs of step keep_at (None: not reached)
    last: list             # outputs of the last step
    traced_steps: int      # steps inside the trace (0 untraced)
    peak_at_keep: int = 0  # clock.peak() just before `kept` was kept


def run(step, seconds: float, in_flight: int, clock, keep_at: int = -1,
        annotate: bool = False, trace_seconds: float | None = None,
        stop_trace=None) -> Window:
    """Run `step()` (which returns the step's outputs) until `seconds` of
    host time have passed, keeping the outputs of step `keep_at` and of
    the last step."""
    def span(name):
        if annotate:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    marks = [clock.mark()]
    host, kept, outs = [], None, None
    traced = peak_at_keep = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        if i >= in_flight:
            with span("portbench.wait"):
                clock.wait(marks[i + 1 - in_flight])
        outs = None
        with span("portbench.gemm"):
            t = time.perf_counter()
            outs = step()
            host.append((time.perf_counter() - t) * 1e3)
        marks.append(clock.mark())
        if i == keep_at:
            peak_at_keep = clock.peak()
            kept = outs
        i += 1
        now = time.perf_counter() - t0
        if trace_seconds is not None and not traced and (
                now >= trace_seconds or now >= seconds):
            clock.sync()
            stop_trace()
            traced = i
            annotate = False
        if now >= seconds:
            break
    clock.sync()
    step_ms = [clock.elapsed_ms(marks[j], marks[j + 1]) for j in range(i)]
    return Window(step_ms, host, clock.elapsed_ms(marks[0], marks[-1]) / 1e3,
                  kept, outs, traced, peak_at_keep)


def percentile(values, q: float) -> float:
    """The q-th percentile of values, by linear interpolation between the
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(steps: int, flops_per_step: float, span_s: float) -> float:
    """TFLOP/s: all the window's useful operations over all its time."""
    return steps * flops_per_step / span_s / 1e12
