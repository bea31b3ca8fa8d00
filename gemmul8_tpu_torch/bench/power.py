"""The card's SM clock and power draw, sampled by nvidia-smi while a block
of work runs.

The reference harness reads the power draw through NVML every 100 ms over
a loop of at least 10 s per row (`watt_check`); here `nvidia-smi
--query-gpu=clocks.sm,power.draw.instant -lms <interval>` runs beside the
block. The instant draw, since nvidia-smi's `power.draw` is a one-second
average on Hopper drivers and lags a block of a few hundred ms. A sampler
that gets no power reading raises: the harness never writes a made-up
wattage.
"""

from __future__ import annotations

import subprocess

import numpy as np


class ClockSampler:
    """nvidia-smi's SM clock and power draw every `interval_ms` while the
    block runs. The block starts once the first sample is in, so that a
    block of a few hundred ms is sampled from its start (nvidia-smi takes
    longer than that to come up); that first sample is taken before the
    block and is left out of `watts`."""

    def __init__(self, interval_ms: int = 20):
        self.interval_ms = int(interval_ms)

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw.instant",
                 "--format=csv,noheader,nounits",
                 "-lms", str(self.interval_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError as exc:
            raise RuntimeError(f"cannot start nvidia-smi: {exc}") from exc
        self.first = self.proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        samples = [_sample(line) for line in (self.first + out).splitlines()]
        # the samples taken while the block ran: all but the first line
        self.mhz = [s[0] for s in samples[1:] if s]
        self.power = [s[1] for s in samples[1:] if s]

    def medians(self):
        """(SM clock MHz, power draw W): the medians of the samples taken
        while the block ran, NaN when none landed in it (a block shorter
        than the interval)."""
        if not self.mhz:
            return float("nan"), float("nan")
        return float(np.median(self.mhz)), float(np.median(self.power))

    def summary(self):
        """'SM clock median ... MHz, power draw median ... W (n samples)'
        of the samples taken while the block ran."""
        if not self.mhz:
            return "SM clock and power draw not sampled"
        mhz, watts = self.medians()
        return (f"SM clock median {mhz:.0f} MHz, power draw median "
                f"{watts:.1f} W ({len(self.mhz)} samples)")

    def watts(self) -> float:
        """Mean power draw (W) of the samples taken while the block ran;
        raises RuntimeError when there is none."""
        if not self.power:
            raise RuntimeError("nvidia-smi gave no power.draw.instant "
                               "sample while the block ran")
        return float(np.mean(self.power))


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (the
    first card's line)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"cannot read the card's name and power limit "
                           f"from nvidia-smi: {exc}") from exc
    return out.strip().splitlines()[0].strip()


def _sample(line: str):
    """(MHz, W) of one line of nvidia-smi's output, or None for a partial
    or [N/A] sample."""
    cells = [c.strip() for c in line.split(",")]
    try:
        return float(cells[0]), float(cells[1])
    except (IndexError, ValueError):
        return None
