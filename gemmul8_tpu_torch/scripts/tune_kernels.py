"""Launch-shape sweeps of the Hopper kernels on the card.

Counterpart of `scripts/tune_kernels.py`:

    python -m gemmul8_tpu_torch.scripts.tune_kernels [n=8192] [L=14]
        [which=all|stats|encode|fusedenc|mmpipe|recon|matmul]

with the JAX script's positional arguments, defaults and inputs: A is
`(rng.random((n, n)) - 0.5) * exp(0.5 rng.standard_normal((n, n)))` from
`default_rng(0)`, its rows (axis 1) and its columns (axis 0) the two
operands; int8 slices and uint8 residues (0..172) of shape (L, n, n) come
from the same generator, drawn once when a section first needs them
(mmpipe and matmul share one draw).

The JAX script times Pallas block shapes. Here a launch entry
(hopper/launch.py) is compiled into its kernel, so each candidate entry
builds into a library of its own (`build.build_candidates`: one source,
its defines, the same nvcc flags; a section's candidates compile in
parallel) and runs through its wrapper's `launch=` keyword. Sections and
their sweeps, each around the table's entry for (9, 0):

    stats     fast_sft (`FastSftLaunch`, both operands), and mag7.cu's
              blocking (`Mag7Launch`): emax, mag7 and mag7_fused
    encode    encode_slices (`EncodeLaunch`, both operands)
    fusedenc  fast_encode_fused (`FastEncodeFusedLaunch`, both operands)
    mmpipe    matmul_mod_u8_pipelined (`MatmulModLaunch`, tile 128:
              stages 2-6 x raster group 4, 8, 16, 32)
    recon     reconstruct (`ReconstructLaunch`, uint8 residues)
    matmul    matmul_mod_u8 (`MatmulModLaunch`, tile 256, the only width
              its source takes: stages 2-4 x raster group 1, 4, 8, 16, 32)

What has no counterpart: the JAX script's `encode vpu` rows (the port has
one encode kernel, on the tensor cores, for every form) and its stats
sweep over the chunk width (the 2048-element chunk, like the row block's
threads and a column's 16 runs, sets the order of the norm's sums, which
the fast shift's bits follow: it is not a launch entry).

Every candidate is first checked against its source's `static_assert`s
(`launch.fits`, the shared-memory formula among them): one that cannot
build is listed and skipped. Then every candidate that builds is run on
the same inputs as the table's entry and its output compared word for
word with the table library's: launch shapes move no bit, so a difference
is a fault (`FAIL` with the count of differing words). A candidate that
fails to compile or launch prints `FAIL` with the first line of the
error, and the sweep goes on. Then the table's entry and every candidate
that passed are timed by CUDA events, each the median of rotated rounds
(the order rotates by one a round, and every round holds the table's
entry, so each ratio is taken within one rotation), with nvidia-smi's SM
clock and power draw sampled beside each rotation (`ClockSampler`).

Each row gives the entry, its median ms and rounds, its rate (GB/s for a
byte-bound kernel, TOPS for an operation-bound one) and its share of the
bound `PERF.md` §6 uses (`bench.bounds.kernel_bounds`), its ratio to the
table's entry in the same rotation, its ptxas registers and spill bytes,
and the rotation's median SM clock and power draw; the card's name and
power limit are printed once. A candidate with spill bytes is never a
table entry. `main` exits nonzero without a card, if any candidate's
bits differed, or if the table's own entry failed.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..bench.bounds import kernel_bounds
from ..bench.power import ClockSampler
from ..hopper import build
from ..hopper import kernels as hk
from ..hopper import launch as hl
from ..hopper import matmul as hm
from ..hopper.launch import (EncodeLaunch, FastEncodeFusedLaunch,
                             FastSftLaunch, Mag7Launch, MatmulModLaunch,
                             ReconstructLaunch)

SECTIONS = ("stats", "encode", "fusedenc", "mmpipe", "recon", "matmul")
ROUNDS = 5            # rotated rounds a sweep
WINDOW_MS = 60.0      # a timing's least length: reps fill it
CAPABILITY = (9, 0)


@dataclass(frozen=True)
class Sweep:
    section: str
    entry: str        # the launch entry's name (hopper/launch.py)
    source: str       # its source, csrc/<source>
    candidates: tuple  # entries around the table's, before the fit check


def _mm(stages, groups, tile):
    return tuple(MatmulModLaunch(tile, s, g) for s in stages for g in groups)


SWEEPS = (
    Sweep("stats", "fast_sft", "fast_sft.cu", (
        FastSftLaunch(8, 3), FastSftLaunch(16, 3), FastSftLaunch(64, 3),
        FastSftLaunch(32, 2), FastSftLaunch(32, 4), FastSftLaunch(16, 4))),
    Sweep("stats", "mag7", "mag7.cu", (
        Mag7Launch(32, 16, 256, 64, 4, 128),
        Mag7Launch(32, 8, 512, 64, 4, 128),
        Mag7Launch(32, 8, 256, 32, 4, 128),
        Mag7Launch(32, 8, 256, 64, 4, 128),
        Mag7Launch(32, 8, 256, 128, 4, 128),
        Mag7Launch(32, 8, 256, 64, 8, 128),
        Mag7Launch(16, 8, 256, 64, 4, 256),
        Mag7Launch(64, 8, 256, 64, 4, 64))),
    Sweep("encode", "encode", "encode.cu", (
        EncodeLaunch(256, 4), EncodeLaunch(256, 8), EncodeLaunch(256, 16),
        EncodeLaunch(128, 16),
        EncodeLaunch(512, 4), EncodeLaunch(512, 8), EncodeLaunch(1024, 2))),
    Sweep("fusedenc", "fast_encode_fused", "fast_encode_fused.cu", (
        FastEncodeFusedLaunch(32 * 1024, 8),
        FastEncodeFusedLaunch(128 * 1024, 8),
        FastEncodeFusedLaunch(192 * 1024, 8),
        FastEncodeFusedLaunch(64 * 1024, 16),
        FastEncodeFusedLaunch(64 * 1024, 32))),
    Sweep("mmpipe", "matmul_mod_pipelined", "matmul_mod_pipelined.cu",
          _mm(range(2, 7), (4, 8, 16, 32), 128)),
    Sweep("recon", "reconstruct", "reconstruct.cu", (
        ReconstructLaunch(128, 128, 8), ReconstructLaunch(128, 128, 32),
        ReconstructLaunch(64, 128, 16), ReconstructLaunch(64, 128, 32),
        ReconstructLaunch(32, 128, 32), ReconstructLaunch(256, 128, 16))),
    Sweep("matmul", "matmul_mod", "matmul_mod.cu",
          _mm((2, 3, 4), (1, 4, 8, 16, 32), 256)),
)


def sweeps(section: str) -> tuple:
    """The sweeps of a section, in order."""
    if section not in SECTIONS:
        raise ValueError(f"section {section!r}: one of {SECTIONS}")
    return tuple(s for s in SWEEPS if s.section == section)


def candidates(sweep: Sweep, entries=None) -> tuple:
    """(the entries to run, the table's first; [(entry, why)] of those
    that cannot build) of a sweep over `entries` (default: its own)."""
    table = hl.get(sweep.entry, CAPABILITY)
    run, dropped = [table], []
    for e in sweep.candidates if entries is None else entries:
        if e == table or e in run:
            continue
        if hl.fits(sweep.entry, e):
            run.append(e)
        else:
            dropped.append((e, f"fails its source's static_assert "
                               f"({hl.smem_bytes(sweep.entry, e)} bytes of "
                               f"shared memory; limits {hl.SMEM_STATIC} "
                               f"static, {hl.SMEM_BLOCK} a block)"))
    return tuple(run), dropped


class Inputs:
    """The JAX script's inputs at n and L on the card, each drawn from one
    default_rng(0) when first asked for. with_a=False: no A is drawn
    first (the matmul tuner's slices come first from its generator)."""

    def __init__(self, n: int, L: int, with_a: bool = True):
        self.n, self.L = n, L
        self.rng = np.random.default_rng(0)
        self._slices = self._residues = None
        self.a = None
        if with_a:
            a = ((self.rng.random((n, n)) - 0.5)
                 * np.exp(self.rng.standard_normal((n, n)) * 0.5))
            self.a = torch.from_numpy(a).to("cuda")

    def slices(self):
        """(a8, b8): (L, n, n) int8 each."""
        if self._slices is None:
            shape = (self.L, self.n, self.n)
            self._slices = tuple(
                torch.from_numpy(self.rng.integers(
                    -128, 128, shape, dtype=np.int8)).to("cuda")
                for _ in range(2))
        return self._slices

    def residues(self):
        """(L, n, n) uint8 in 0..172, the JAX script's `r8`."""
        if self._residues is None:
            self._residues = torch.from_numpy(self.rng.integers(
                0, 173, (self.L, self.n, self.n), dtype=np.uint8)).to("cuda")
        return self._residues


def calls(sweep: Sweep, inp: Inputs) -> dict:
    """label -> fn(launch entry or None): the sweep's kernel calls, each
    the main path's use of the kernel (both operands where the path runs
    it twice); the label is its `kernel_bounds` key."""
    L = inp.L
    if sweep.entry == "matmul_mod":
        a8, b8 = inp.slices()
        return {"matmul_mod_u8": lambda e: hm.matmul_mod_u8(
            a8, b8, L, centered=True, launch=e)}
    if sweep.entry == "matmul_mod_pipelined":
        a8, b8 = inp.slices()
        return {"matmul_mod_u8_pipelined":
                lambda e: hm.matmul_mod_u8_pipelined(a8, b8, L, launch=e)}
    a = inp.a
    if sweep.entry == "fast_sft":
        return {"fast_sft": lambda e: (hk.fast_sft(a, L, 1, launch=e),
                                       hk.fast_sft(a, L, 0, launch=e))}
    if sweep.entry == "mag7":
        ea, eb = hk.emax(a, 1), hk.emax(a, 0)
        return {"emax": lambda e: (hk.emax(a, 1, launch=e),
                                   hk.emax(a, 0, launch=e)),
                "mag7": lambda e: (hk.mag7(a, ea, 1, launch=e),
                                   hk.mag7(a, eb, 0, launch=e)),
                "mag7_fused": lambda e: (hk.mag7_fused(a, 1, launch=e),
                                         hk.mag7_fused(a, 0, launch=e))}
    if sweep.entry == "fast_encode_fused":
        return {"fast_encode_fused": lambda e: (
            hk.fast_encode_fused(a, L, 1, launch=e),
            hk.fast_encode_fused(a, L, 0, launch=e))}
    sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(a, L, 0)
    if sweep.entry == "encode":
        return {"encode_slices": lambda e: (
            hk.encode_slices(a, sa, L, 1, launch=e),
            hk.encode_slices(a, sb, L, 0, launch=e))}
    if sweep.entry == "reconstruct":
        r8 = inp.residues()
        return {"reconstruct": lambda e: hk.reconstruct(r8, sa, sb, L,
                                                        launch=e)}
    raise KeyError(sweep.entry)


def _flat(out) -> list:
    """The tensors of a kernel's output (nested tuples flattened)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _words(t: torch.Tensor) -> torch.Tensor:
    """t's elements as integers of its width (IEEE bits for floats)."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if t.dtype.is_floating_point:
        ints = {8: torch.int64, 4: torch.int32}[t.element_size()]
        return t.contiguous().view(ints)
    return t


def differing_words(got, want) -> int:
    """How many words of output `got` differ from `want` (a shape that
    differs counts every word)."""
    n = 0
    for x, y in zip(_flat(got), _flat(want), strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            n += max(x.numel(), y.numel())
        else:
            n += int((_words(x) != _words(y)).sum())
    return n


def rotated_rounds(fns: dict, rounds: int, reps: int) -> dict:
    """key -> [ms per call] over `rounds` rounds of CUDA-event timings of
    `reps` calls each, the order rotating by one a round."""
    keys = list(fns)
    for k in keys:                       # warm-up
        fns[k]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    by = {k: [] for k in keys}
    for r in range(rounds):
        shift = r % len(keys)
        for k in keys[shift:] + keys[:shift]:
            start.record()
            for _ in range(reps):
                fns[k]()
            stop.record()
            torch.cuda.synchronize()
            by[k].append(start.elapsed_time(stop) / reps)
    return by


@dataclass
class Row:
    label: str          # the kernel call ("fast_sft", "mag7", ...)
    entry: object       # the launch entry
    table: bool         # the table's own entry
    ms: float = float("nan")
    rounds: list = field(default_factory=list)
    ratio: float = float("nan")   # ms / the table entry's ms, one rotation
    bound_ms: float = float("nan")
    bound_by: str = ""
    registers: list = field(default_factory=list)
    spill_bytes: int = 0
    differing: int = 0  # words that differ from the table library's
    error: str = ""     # the first line of a build or launch failure
    clock: str = ""     # the rotation's SM clock and power draw

    @property
    def ok(self) -> bool:
        return not self.error and self.differing == 0


def _first_line(exc: BaseException) -> str:
    text = str(exc).strip()
    return f"{type(exc).__name__}: {text.splitlines()[0] if text else ''}"


def run_section(section: str, inp: Inputs, entries=None,
                rounds: int = ROUNDS, out=print) -> list:
    """Build, check and time a section's sweeps on `inp`. entries: entry
    name -> the candidates to run (default: each sweep's own list).
    Prints each row (and the section's build time) with `out`; returns
    the `Row`s, the table's first in each call."""
    build.lib()
    plan = []
    for sweep in sweeps(section):
        run, dropped = candidates(sweep, None if entries is None
                                  else entries.get(sweep.entry, ()))
        for e, why in dropped:
            out(f"{section} {sweep.entry} {e}: skipped, {why}")
        plan.append((sweep, run))
    t0 = time.perf_counter()
    built = build.build_candidates(
        [(sweep.source, e) for sweep, run in plan for e in run[1:]])
    out(f"{section}: {len(built)} candidate libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    bounds = kernel_bounds(torch.empty(inp.n, inp.n, device="meta"),
                           torch.empty(inp.n, inp.n, device="meta"), inp.L)
    rows = []
    for sweep, run in plan:
        fns = calls(sweep, inp)
        for label, fn in fns.items():
            rows += _sweep_rows(sweep, label, fn, run, built, bounds[label],
                                rounds, out)
        torch.cuda.empty_cache()
    return rows


def _sweep_rows(sweep, label, fn, run, built, bound, rounds, out) -> list:
    """The rows of one kernel call over the entries `run` (the table's
    first)."""
    rows, timed = [], {}
    want = None
    for i, e in enumerate(run):
        lib = None if i == 0 else built[(sweep.source, e)]
        row = Row(label, e, i == 0, bound_ms=bound[0], bound_by=bound[1])
        rows.append(row)
        if isinstance(lib, Exception):
            row.error = _first_line(lib)
            continue
        report = (build.PTXAS_REPORT.get(sweep.source, "") if lib is None
                  else lib.ptxas)
        row.registers = sorted(set(build.registers(report)))
        row.spill_bytes = sum(build.spill_bytes(sweep.source, report))
        launch = None if i == 0 else e
        try:
            got = fn(launch)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as exc:
            row.error = _first_line(exc)
            if i == 0:
                break
            continue
        if i == 0:
            want = got
        else:
            row.differing = differing_words(got, want)
        del got
        if row.ok:
            timed[i] = (lambda launch=launch: fn(launch))
    if timed and rows[0].ok:
        est = rotated_rounds({0: timed[0]}, 1, 1)[0][0]
        reps = max(2, math.ceil(WINDOW_MS / est))
        with ClockSampler() as clock:
            by = rotated_rounds(timed, rounds, reps)
        base = float(np.median(by[0]))
        for i, mss in by.items():
            row = rows[i]
            row.rounds, row.ms = mss, float(np.median(mss))
            row.ratio = row.ms / base
            row.clock = clock.summary()
    del want
    for row in rows:
        out(format_row(sweep.section, row))
    return rows


def format_row(section: str, row: Row) -> str:
    """One row: the entry, ms, rate, share of the bound, ratio to the
    table's entry, registers and spills, bits, clock."""
    head = (f"{section} {row.label} {'table ' if row.table else ''}"
            f"{row.entry}")
    if row.error:
        return f"{head}: FAIL {row.error}"
    if row.differing:
        return (f"{head}: FAIL {row.differing} words differ from the table "
                "library's")
    regs = (f"{row.registers[0]}-{row.registers[-1]}" if len(row.registers)
            > 1 else "".join(map(str, row.registers)) or "?")
    share = row.bound_ms / row.ms
    rate = (f"{share * 3350:.0f} GB/s" if row.bound_by == "bytes"
            else f"{share * 1979:.1f} TOPS")
    spread = ""
    if row.table and row.rounds:
        rel = (max(row.rounds) - min(row.rounds)) / row.ms
        spread = f", rounds spread {rel:.3f} of the median"
    return (f"{head}: {row.ms:.3f} ms (rounds "
            f"{', '.join(f'{t:.3f}' for t in row.rounds)}{spread}), {rate}, "
            f"share {share:.3f} of the {row.bound_ms:.3f} ms bound "
            f"({row.bound_by}), ratio {row.ratio:.3f} to the table's entry; "
            f"ptxas {regs} registers, {row.spill_bytes} spill bytes; bits "
            f"equal; {row.clock}")


def parse(argv, sections=SECTIONS) -> tuple:
    """(n, L, which) from the JAX script's positional arguments."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if len(argv) > 0 else 8192
    L = int(argv[1]) if len(argv) > 1 else 14
    which = argv[2] if len(argv) > 2 else "all"
    if which != "all" and which not in sections:
        raise SystemExit(f"which={which!r}: all or one of {sections}")
    return n, L, which


def failed(rows) -> bool:
    """Whether a run failed: a candidate's bits differed, or a table
    entry failed."""
    return any(r.differing or (r.table and r.error) for r in rows)


def main(argv=None) -> int:
    from ..bench.power import card_line
    from ..bench.timing import require_gpu

    n, L, which = parse(argv)
    require_gpu()
    print(f"card (name, power limit): {card_line()}", flush=True)
    inp = Inputs(n, L)
    rows = []
    for section in SECTIONS if which == "all" else (which,):
        rows += run_section(section, inp,
                            out=lambda s: print(s, flush=True))
    return 1 if failed(rows) else 0


if __name__ == "__main__":
    sys.exit(main())
