"""The work of one emulated GEMM call, phase by phase, and its bound.

A frozen copy of the arithmetic of `gemmul8_tpu_torch/bench/bounds.py`,
split by the phase of work rather than by kernel, so that the benchmark's
rooflines follow the work whatever kernel does it. Its rule: each input
read once and each output written once, at the H100 SXM5 data sheet's
dense peaks (3.35 TB/s of device memory, 1,979 TOP/s int8), which assume
the full 700 W power limit.

A call's phases, as Ozaki Scheme II does them:

    stats   reads A, B            writes the shifts (int32 a row of A and
                                  a column of B)
    encode  reads A, B, shifts    writes the int8 residue slices
    gemm    reads the slices      writes the residues of the products
    crt     reads residues, shifts  writes C

A complex call holds two parts of each operand in one word each, and its
gemm phase computes the four real products of the classical formula.

Where one kernel does the work of several phases, their work merges
(`merge`): a tensor written inside the merged group is no longer read,
and one that no phase outside the group reads is no longer written, so a
fused kernel is held to the bound of the work it must still do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

PHASES = ("stats", "encode", "gemm", "crt")


@dataclass(frozen=True)
class Work:
    """int8 tensor-core operations, and the bytes of each tensor read and
    written, by the tensor's name."""
    ops: float = 0.0
    reads: dict = field(default_factory=dict)
    writes: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> float:
        return float(sum(self.reads.values()) + sum(self.writes.values()))


def bound_ms(work: Work) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for `work`, the larger of its bytes at HBM_BYTES_PER_S and its
    operations at INT8_OPS_PER_S."""
    t_bytes = work.nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_work(m: int, n: int, k: int, num_moduli: int, word: int,
              out_word: int, complex_: bool) -> dict:
    """{phase: Work} of one call: A (m, k) and B (k, n) held in `word`
    bytes an element part, C (m, n) written in `out_word` bytes a part,
    two parts an element for a complex call."""
    parts = 2 if complex_ else 1
    L = num_moduli
    a = parts * word * m * k
    b = parts * word * k * n
    sft = 4 * (m + n)
    slices = parts * L * (m * k + k * n)
    residues = parts * L * m * n
    return {
        "stats": Work(0.0, {"A": a, "B": b}, {"sft": sft}),
        "encode": Work(0.0, {"A": a, "B": b, "sft": sft},
                       {"slices": slices}),
        "gemm": Work(parts * parts * L * 2.0 * m * n * k,
                     {"slices": slices}, {"residues": residues}),
        "crt": Work(0.0, {"residues": residues, "sft": sft},
                    {"C": parts * out_word * m * n}),
    }


def merge(phases: dict, group) -> Work:
    """The work of the phases in `group` done together: their operations
    summed; a tensor written inside the group is not read; a tensor the
    group writes is still written only where a phase outside it reads it,
    or where no phase reads it at all (the call's output)."""
    group = set(group)
    inside = [phases[p] for p in phases if p in group]
    outside = [phases[p] for p in phases if p not in group]
    written = {t for w in inside for t in w.writes}
    read_inside = {t for w in inside for t in w.reads}
    read_outside = {t for w in outside for t in w.reads}
    reads = {t: v for w in inside for t, v in w.reads.items()
             if t not in written}
    writes = {t: v for w in inside for t, v in w.writes.items()
              if t in read_outside or t not in read_inside}
    return Work(sum(w.ops for w in inside), reads, writes)


def useful_flops(m: int, n: int, k: int, complex_: bool) -> float:
    """The operations a user counts for the call: 2mnk real, 8mnk complex
    (the classical ZGEMM / CGEMM count)."""
    return (8.0 if complex_ else 2.0) * m * n * k
