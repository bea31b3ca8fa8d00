"""Spans and counters of gemmul8_tpu_torch: the port's one tracing system.

Recording is on only inside `recording()`:

    with gemmul8_tpu_torch.trace.recording() as rec:
        c = gemmul8_tpu_torch.gemm(a, b)
    rec.by_layer()   # {"api": Layer(self_ms, launches, nbytes), ...}

Outside it, `span(name)` returns one shared no-op context after a single
test of a module flag: it allocates nothing and touches no torch, and
`traced` functions call straight through. Inside it, each span records
its name, its host start and end (`time.perf_counter_ns()`), its parent,
and the call id of the root span it lies under: every span under one
public `api` call shares that call's id. A `hopper` wrapper's launches,
and the device bytes of the outputs and workspaces it made, go on its
span (`count`, from `hopper.build.launched`, which also keeps
`hopper.build.LAUNCHES`). Beside `LAUNCHES`, and not on the spans,
`hopper.build.B_COPIES` counts the copies of B into a K-major workspace
by the wrapper that made them (`hopper.build.copied_b`): 0 on the default
real and complex paths, whose encode writes B K-major. Closed spans are
kept in memory as tuples; nothing is written on the way.

A span opened with `made=True` (`gm8.api.epilogue`, around torch
operations rather than a wrapper) puts on itself the device bytes of every
tensor a torch operation inside it makes (`count(0, made)`): a result that
shares no storage with the operation's tensor arguments, 0-dim scalars
left out. It adds nothing to `LAUNCHES`. `core.gemm.OPERAND_COPIES`
counts the copies the real schedules' `.contiguous()` made of an operand
that came strided (a view), while recording is on (`active()`). Outside
recording each of them costs one test of the module flag, as every span
and count here does.

While a `torch.profiler` records, each span also enters
`torch.profiler.record_function(name)`, so that it lands in the
profiler's Chrome trace as a `user_annotation` event on the clock of the
device events, around the `cuda_runtime` calls that launched them. While
none records, `record_function` is never entered.

Span names follow the layers, `gm8.<layer>.<function>`: `gm8.api.*` the
public front end (argument handling, the complex parts; the epilogue, where
alpha != 1 or beta != 0, as `gm8.api.epilogue`),
`gm8.core.*` the schedules, `gm8.hopper.*` the wrappers that reach a C
entry point (`hopper/kernels.py`, `matmul.py`, `pipelined.py`,
`probes.py`).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.overrides import TorchFunctionMode

# the Recorder of the open recording(), None while recording is off
_recorder = None
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    parent: int | None   # the enclosing span's id; None for a root
    call: int            # the root span's call id
    name: str
    start_ns: int
    end_ns: int
    launches: int        # kernel launches counted on this span itself
    nbytes: int          # device bytes its wrapper made

    @property
    def layer(self) -> str:
        return self.name.split(".")[1]


class Layer(NamedTuple):
    self_ms: float   # host time in the layer's spans less their children's
    launches: int
    nbytes: int


class Recorder:
    """The spans of one `recording()`, in the order they closed."""

    def __init__(self):
        self.spans: list[Span] = []
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def self_ns(self, calls=None) -> dict:
        """{span id: its duration less what its child spans cover}, over
        the spans of the call ids `calls` (all spans for None)."""
        spans = [s for s in self.spans if calls is None or s.call in calls]
        own = {s.id: s.end_ns - s.start_ns for s in spans}
        for s in spans:
            if s.parent in own:
                own[s.parent] -= s.end_ns - s.start_ns
        return own

    def by_layer(self, calls=None) -> dict:
        """{layer: Layer} over the spans of the call ids `calls` (all spans
        for None)."""
        own = self.self_ns(calls)
        out = {}
        for s in self.spans:
            if s.id in own:
                ns, n, b = out.get(s.layer, (0, 0, 0))
                out[s.layer] = (ns + own[s.id], n + s.launches,
                                b + s.nbytes)
        return {k: Layer(ns / 1e6, n, b) for k, (ns, n, b) in out.items()}


class _Made(TorchFunctionMode):
    """While entered, counts on the innermost open span the bytes of each
    tensor a torch operation makes: a result that shares no storage with
    the operation's tensor arguments; 0-dim scalars left out."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        given = {x.untyped_storage().data_ptr()
                 for x in (*args, *kwargs.values())
                 if isinstance(x, torch.Tensor)}
        count(0, [t for t in (out if isinstance(out, tuple) else (out,))
                  if isinstance(t, torch.Tensor) and t.dim()
                  and t.untyped_storage().data_ptr() not in given])
        return out


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "call", "start", "launches",
                 "nbytes", "annotation", "made")

    def __init__(self, rec: Recorder, name: str, made: bool = False):
        self.rec = rec
        self.name = name
        self.made = _Made() if made else None

    def __enter__(self):
        stack = self.rec._stack()
        top = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.parent = None if top is None else top.id
        self.call = next(self.rec._calls) if top is None else top.call
        self.launches = self.nbytes = 0
        self.annotation = None
        stack.append(self)
        self.start = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.made is not None:
            self.made.__enter__()
        return self

    def __exit__(self, *exc):
        if self.made is not None:
            self.made.__exit__(*exc)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.perf_counter_ns()
        self.rec._stack().pop()
        self.rec.spans.append(Span(self.id, self.parent, self.call,
                                   self.name, self.start, end, self.launches,
                                   self.nbytes))
        return False


@contextlib.contextmanager
def recording():
    """Turn recording on for the block; yields its `Recorder`, which keeps
    the spans after the block. Raises RuntimeError if one is open."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("recording() is already open")
    _recorder = rec = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


def active() -> bool:
    """Whether recording is on."""
    return _recorder is not None


def span(name: str, made: bool = False):
    """A context that records span `name` while recording is on; the
    shared no-op otherwise. With `made`, the span also carries the device
    bytes of the tensors the torch operations inside it make."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, made)


def traced(name: str):
    """Decorator: the function's calls as span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _recorder is None:
                return fn(*args, **kwargs)
            with _Span(_recorder, name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(launches: int, made=()) -> None:
    """Put `launches` and the device bytes of the tensors `made` on this
    thread's innermost open span, while recording is on."""
    rec = _recorder
    if rec is None:
        return
    stack = rec._stack()
    if stack:
        top = stack[-1]
        top.launches += launches
        top.nbytes += sum(t.untyped_storage().nbytes() for t in made)
