"""The program's own spans in a traced run, read into per-layer numbers.

Where the program has `gemmul8_tpu_torch.trace`, `recording(program)`
turns its recorder on around the window (a context that yields None where
the program has none, as at a commit before it). The program's spans are
named `gm8.<layer>.<function>`, for the layers `api`, `core` and
`hopper`; while the profiler records they also land in its Chrome trace
as `user_annotation` events. From them, each reader a function of the
run's context `ctx`, and None where it lacks what it reads (`recorder`,
`chrome`, `mem`):

- `host_ms(ctx, layer)`: the layer's host self time (its spans less their
  child spans), per step, over the steps after the traced stretch, which
  bear no profiler cost (as `host_ms` is read);
- `device_ms(ctx, layer)`: device time per traced step of the kernels,
  copies and fills whose launch (the `cuda_runtime` or `cuda_driver`
  event of the same `args.correlation`) started inside one of the
  layer's spans, the innermost open on the launching thread; with layer
  None, those no program span launched;
- `alloc_gib(ctx)`: device bytes the `hopper` spans made (outputs and
  workspaces), per step;
- `device_mallocs(ctx)`: the caching allocator's new segments and
  retries (`segment.all.allocated` and `num_alloc_retries` of
  `torch.cuda.memory_stats()`, read at the window's open and close,
  `ctx.mem`) per 1000 steps;
- `top_gaps(trace)`: the idle gaps of a `devtrace.Trace`, each named by
  the benchmark span, the innermost program span and the innermost other
  CPU operation open when the gap began.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

from .devtrace import DEVICE_CATS

PREFIX = "gm8."
BENCH = "portbench."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def recording(program):
    """The program's `trace.recording()`, which yields its recorder, or a
    context that yields None where the program has none."""
    if program is None:
        return contextlib.nullcontext()
    try:
        from gemmul8_tpu_torch import trace
    except ImportError:
        return contextlib.nullcontext()
    rec = getattr(trace, "recording", None)
    return rec() if rec is not None else contextlib.nullcontext()


def _layer(name):
    return name.split(".")[1] if name and name.startswith(PREFIX) else None


def launching_spans(chrome: dict) -> dict:
    """{correlation id: the innermost program span open on the launching
    thread when the launch call of that id started, or None}."""
    events = [e for e in chrome.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    spans, calls = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            spans[e.get("tid")].append(e)
        elif (e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})):
            calls[e.get("tid")].append(e)
    out = {}
    for tid, launches in calls.items():
        opened = sorted(spans[tid], key=lambda e: (e["ts"], -e["dur"]))
        stack, i = [], 0
        for call in sorted(launches, key=lambda e: e["ts"]):
            t = call["ts"]
            while i < len(opened) and opened[i]["ts"] <= t:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < \
                        opened[i]["ts"]:
                    stack.pop()
                stack.append(opened[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
                stack.pop()
            out[call["args"]["correlation"]] = (stack[-1]["name"] if stack
                                                else None)
    return out


def device_us_by_span(chrome: dict) -> dict:
    """{innermost launching program span (None: none): device us} over the
    trace's kernels, copies and fills."""
    spans = launching_spans(chrome)
    out = defaultdict(float)
    for e in chrome.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e:
            corr = e.get("args", {}).get("correlation")
            out[spans.get(corr)] += float(e["dur"])
    return dict(out)


def _untraced_calls(ctx):
    """The call ids of the root spans of the steps after the traced
    stretch."""
    roots = sorted((s for s in ctx.recorder.spans if s.parent is None),
                   key=lambda s: s.start_ns)
    return {s.call for s in roots[ctx.window.traced_steps
                                  * len(ctx.plan.calls):]}


def host_ms(ctx, layer: str):
    rec = getattr(ctx, "recorder", None)
    untraced = len(ctx.window.host_ms) - ctx.window.traced_steps
    if rec is None or untraced <= 0:
        return None
    got = rec.by_layer(calls=_untraced_calls(ctx)).get(layer)
    return got.self_ms / untraced if got is not None else 0.0


def device_ms(ctx, layer):
    chrome = getattr(ctx, "chrome", None)
    if (getattr(ctx, "recorder", None) is None or chrome is None
            or not ctx.window.traced_steps):
        return None
    us = sum(v for k, v in device_us_by_span(chrome).items()
             if _layer(k) == layer)
    return us / 1e3 / ctx.window.traced_steps


def alloc_gib(ctx):
    rec = getattr(ctx, "recorder", None)
    if rec is None or not ctx.steps:
        return None
    got = rec.by_layer().get("hopper")
    return (got.nbytes if got is not None else 0) / ctx.steps / 2**30


def device_mallocs(ctx):
    mem = getattr(ctx, "mem", None)
    if not mem or not ctx.steps:
        return None
    opened, closed = mem
    keys = ("segment.all.allocated", "num_alloc_retries")
    new = sum(closed.get(k, 0) - opened.get(k, 0) for k in keys)
    return 1000.0 * new / ctx.steps


def host_at(trace, t: float) -> str:
    """The benchmark span, the innermost program span and the innermost
    other CPU operation open on the host at time t."""
    ours = prog = inner = None
    for o in trace.host:
        if o.ts > t:
            break
        if o.end >= t:
            if o.name.startswith(BENCH):
                ours = o.name
            elif o.name.startswith(PREFIX):
                prog = o.name
            else:
                inner = o.name
    return " > ".join([ours or "no portbench span"]
                      + [n for n in (prog, inner) if n])


def top_gaps(trace, n: int = 10) -> list:
    longest = sorted(trace.gaps(), key=lambda g: -g[1])[:n]
    return [[host_at(trace, t), d * 1e-6] for t, d in longest]
