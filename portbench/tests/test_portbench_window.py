"""The window's rate is all work over all time, its tail is over all
steps, and at most `in_flight` steps are queued."""

import importlib.util
import statistics
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import window

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(step_ms, flops=2e12):
    win = window.Window(step_ms, [0.1] * len(step_ms), sum(step_ms) / 1e3,
                        None, [], 0)
    return SimpleNamespace(steps=len(step_ms), window=win,
                           plan=SimpleNamespace(flops_per_step=flops))


@pytest.mark.parametrize("stalled", [1, 6, 20])
def test_a_stall_moves_rate_and_tail(stalled):
    steady = [10.0] * 200
    stall = list(steady)
    for i in range(50, 50 + stalled):
        stall[i] = 60.0
    tflops, p95 = reader("tflops"), reader("step_ms_p95")
    # the rate counts every millisecond of the stall
    assert tflops(ctx(steady)) == pytest.approx(200.0)
    assert tflops(ctx(stall)) == pytest.approx(
        200 * 2e12 / ((2000 + 50 * stalled) / 1e3) / 1e12)
    # the tail is of all steps: past 5% of them stalled it reads the stall
    assert p95(ctx(steady)) == 10.0
    assert (p95(ctx(stall)) > 10.0) == (stalled > 10)
    # a median of pieces would not see it
    assert statistics.median(stall) == 10.0


def test_percentile_interpolates_like_numpy():
    xs = [3.0, 1.0, 2.0, 4.0, 10.0]
    assert window.percentile(xs, 50) == 3.0
    assert window.percentile(xs, 95) == pytest.approx(4.0 + 0.8 * 6.0)
    assert window.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        window.percentile([], 95)


class FakeClock:
    """Marks are step counts; records which marks the host waited on."""

    def __init__(self):
        self.n, self.waited, self.synced = 0, [], 0

    def mark(self):
        return self.n

    def wait(self, mark):
        self.waited.append(mark)

    def sync(self):
        self.synced += 1

    def elapsed_ms(self, m0, m1):
        return float(m1 - m0)

    def peak(self):
        return 100 * self.n


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_in_flight_waits_and_keeps(in_flight):
    clock = FakeClock()

    def step():
        clock.n += 1
        return [clock.n]

    win = window.run(step, 0.05, in_flight, clock, keep_at=2)
    steps = len(win.step_ms)
    assert steps >= 3
    # before step i the host waited for the mark after step i - in_flight
    assert clock.waited == list(range(1, steps - in_flight + 1))
    assert win.kept == [3] and win.last == [steps]
    assert win.step_ms == [1.0] * steps and win.span_s == steps / 1e3
    assert clock.synced == 1 and win.traced_steps == 0
    # the peak is read once step 2 is dispatched, before it is kept
    assert win.peak_at_keep == 300


def test_only_the_kept_outputs_are_held_into_the_next_step():
    """The host drops each step's outputs before the next step allocates,
    but for those of step keep_at."""
    clock, refs, held = FakeClock(), [], []

    class Out:
        pass

    def step():
        held.append(sum(r() is not None for r in refs))
        clock.n += 1
        out = Out()
        refs.append(weakref.ref(out))
        return [out]

    win = window.run(step, 0.05, 2, clock, keep_at=1)
    assert len(held) >= 3
    # before steps 0 and 1 nothing is held; after, step 1's outputs alone
    assert held[:2] == [0, 0] and set(held[2:]) == {1}
    assert win.kept[0] is refs[1]()


def test_traced_window_stops_its_trace_once():
    clock, stops = FakeClock(), []

    def step():
        clock.n += 1
        return []

    win = window.run(step, 0.05, 2, clock, trace_seconds=0.02,
                     stop_trace=lambda: stops.append(clock.n))
    assert len(stops) == 1 and 1 <= win.traced_steps <= len(win.step_ms)
    assert stops == [win.traced_steps] and clock.synced == 2


def test_host_ms_reads_the_untraced_steps():
    win = window.Window([1.0] * 4, [5.0, 5.0, 0.5, 0.7], 0.004, None, [], 2)
    host = reader("host_ms")
    assert host(SimpleNamespace(window=win)) == pytest.approx(0.6)
    win.traced_steps = 4
    assert host(SimpleNamespace(window=win)) is None
