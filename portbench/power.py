"""The card's name, power limit, SM clock and power draw, from nvidia-smi.

A copy of `gemmul8_tpu_torch/bench/power.py`'s `ClockSampler` and
`card_line`: `nvidia-smi --query-gpu=clocks.sm,power.draw.instant -lms
<interval>` runs beside the window (the instant draw: `power.draw` is a
one-second average on Hopper drivers), and is stopped and waited for when
the window ends. A card under load at its power limit runs at a lower
clock, so every run states the clock its numbers were taken at.
"""

from __future__ import annotations

import statistics
import subprocess
from datetime import datetime


class ClockSampler:
    """nvidia-smi's SM clock and power draw every `interval_ms` from
    entering to leaving, each sample with the time nvidia-smi stamped on
    it, so that a stretch inside can be read alone (`summary`)."""

    def __init__(self, interval_ms: int = 100):
        self.interval_ms = int(interval_ms)
        self.samples = []   # (epoch s, MHz, W or None)

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi",
                 "--query-gpu=timestamp,clocks.sm,power.draw.instant",
                 "--format=csv,noheader,nounits", "-i", "0",
                 "-lms", str(self.interval_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return self
        self.first = self.proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = [s for s in map(_sample, out.splitlines()) if s]

    def summary(self, t0: float, t1: float) -> str:
        """The median SM clock and power draw of the samples stamped
        between epoch seconds t0 and t1."""
        inside = [s for s in self.samples if t0 <= s[0] <= t1]
        if not inside:
            return "SM clock and power draw not sampled"
        watts = [s[2] for s in inside if s[2] is not None]
        draw = (f"{statistics.median(watts):.1f} W" if watts
                else "not read")
        return (f"SM clock median "
                f"{statistics.median(s[1] for s in inside):.0f} MHz, "
                f"power draw median {draw} ({len(inside)} samples)")


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"card name and power limit not read ({exc})"
    return out.strip().splitlines()[0].strip()


def _sample(line: str):
    """(epoch s, MHz, W or None) of one line of nvidia-smi's output
    ("2026/10/18 15:20:01.123, 1515, 699.12"; local time), or None."""
    cells = [c.strip() for c in line.split(",")]
    try:
        t = datetime.strptime(cells[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
        mhz = float(cells[1])
    except (IndexError, ValueError):
        return None
    try:
        watts = float(cells[2])
    except (IndexError, ValueError):
        watts = None
    return t, mhz, watts
