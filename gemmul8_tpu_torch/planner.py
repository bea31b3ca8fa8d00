"""Workspace / memory planner of the port.

Counterpart of `gemmul8_tpu/planner.py`, with the same functions and the
same chunking, but its byte counts model what THIS package holds live on
the card (not the TPU's 128-lane padding, nor the JAX package's int32
product batches): it (a) reports the expected peak auxiliary footprint of a
call for capacity planning, and (b) decides the moduli-chunked low-memory
schedule: when the slice buffers exceed a budget, the moduli loop is split
into chunks whose slices are encoded, multiplied, reduced and folded into
the CRT limbs before the next chunk is made.

What is counted is what is live at the call's peak, tensor by tensor,
each at the most PyTorch's CUDA caching allocator may count for it in
`torch.cuda.max_memory_allocated`: its bytes rounded up to 512, and for a
tensor above 1 MiB another 1 MiB, since the allocator hands out a cached
block whole when splitting it would leave 1 MiB or less. The figure is
thus an upper bound; where every large tensor fills its block exactly
(8192^3) the peak is the figure less 1 MiB a large tensor. That over-count
is a larger share of a small call: 1000 x 4100 x 1500 at 14 moduli in
chunks of 3 holds five large tensors (the limbs, A's slices and their
padded copy, B's K-major slices, the residues) of about 91 MiB in all, and
its peak on an H100 was 95,687,168 bytes, 5.2% under the figure of
100,894,208; in chunks of 5 the same 5 MiB is a smaller share.

A real call's peak is the larger of two moments. During the residue GEMM:
for the moduli held at one time (all of them, or a chunk's) the int8
slices of A (m x k) and of B, which its encode writes K-major (n x kp, kp
= k rounded up to 16) for the GEMM to read in place, A's copy padded to kp
where k is not a multiple of 16 (the GEMM wrapper pads k to kp beside the
unpadded slices) and the one-byte residues (m x n). During the
reconstruct: the residues and the f64 output (8 bytes an element), the
slices being freed by then. A chunked call holds the
int32 CRT limbs (num_limbs x m x n x 4) across both moments, and at its
reconstruct the limbs and the output only. The int32 shifts are live
throughout. The operands themselves are the caller's and are not counted.
Not counted either: the transient the chunk fold makes (one int32 plane,
4mn, below a chunk's slices beside the limbs), and accurate
mode's two int8 magnitude buffers, freed before the first slice is made.

A complex call is counted the same way (an upper bound of the complex128
peak). The call holds the contiguous Re and Im parts of both
operands (`complexgemm.canon_complex`), which it makes itself, throughout.
Its peak is the largest of these moments: the residue GEMM (every slice
set, B's K-major; where k is not a multiple of 16, each A set's copy
padded to kp beside it; the Re and Im residues); for the Karatsuba
strategy the sum of A's and of B's slices (the four slice sets, A's sum
once B's is made, three int16 temporaries of the summed operand's size
and two (L, 1, 1) int16 constants); the reconstruct (the
residues and the two output parts); and the complex output made from the
two parts. The alpha/beta epilogue's temporaries are not counted.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import tables
from .types import ComputeType


def _ceil_to(x: int, a: int) -> int:
    return (x + a - 1) // a * a


_BLOCK = 512          # the CUDA caching allocator rounds every tensor up
_UNSPLIT = 1 << 20    # and leaves a large block's remainder up to this


def _blk(nbytes: int) -> int:
    """The most bytes the caching allocator counts for a tensor of
    nbytes: 512-byte rounding, plus an unsplit remainder above 1 MiB."""
    b = _ceil_to(max(nbytes, 1), _BLOCK)
    return b + _UNSPLIT if b > _UNSPLIT else b


def _real_bytes(m: int, n: int, k: int, L: int, chunk: int | None) -> int:
    """The real peak of `workspace_bytes`: all L moduli at once, or chunk
    of them with the limbs held throughout."""
    kp = _ceil_to(k, 16)
    c = L if chunk is None else chunk
    pad = _blk(c * m * kp) if kp != k else 0
    gemm = _blk(c * m * k) + pad + _blk(c * n * kp) + _blk(c * m * n)
    out = _blk(8 * m * n)
    shifts = _blk(4 * m) + _blk(4 * n)
    if chunk is None:
        return shifts + max(gemm, _blk(L * m * n) + out)
    return shifts + _blk(_limbs(m, n, L)) + max(gemm, out)


def _complex_bytes(m: int, n: int, k: int, L: int, kara: bool) -> int:
    """The complex peak of `workspace_bytes`, 8 bytes a part's word."""
    kp = _ceil_to(k, 16)
    a, b = L * m * k, L * n * kp         # one slice set of A, of B
    sets = 3 if kara else 2
    parts = 2 * _blk(8 * m * k) + 2 * _blk(8 * k * n)
    live = parts + _blk(4 * m) + _blk(4 * n)   # and the shifts
    residues = 2 * _blk(L * m * n)
    out = 2 * _blk(8 * m * n)
    pad = _blk(L * m * kp) if kp != k else 0
    moments = [
        live + sets * (_blk(a) + pad + _blk(b)) + residues,
        live + residues + out,
        parts + out + _blk(16 * m * n)]
    if kara:  # slicegemm.recenter_add_int8: t, t + h, its remainder
        consts = 2 * _blk(2 * L)
        slices = 2 * _blk(a) + 2 * _blk(b)
        moments += [live + slices + 3 * _blk(2 * a) + consts,
                    live + slices + _blk(a) + 3 * _blk(2 * b) + consts]
    return max(moments)


def _limbs(m: int, n: int, num_moduli: int) -> int:
    return tables.num_limbs(num_moduli) * m * n * 4


def workspace_bytes(m: int, n: int, k: int, num_moduli: int,
                    compute_type: ComputeType = ComputeType.REAL_DEFAULT,
                    moduli_chunk: int | None = None) -> int:
    """Expected peak auxiliary bytes on the device for one emulated GEMM
    call (see the module docstring for what is counted).

    Real: the larger of the residue GEMM's buffers for num_moduli (or,
    chunked, moduli_chunk) moduli (A's slices and, at a ragged k, its
    padded copy, B's K-major slices, the residues) and the
    residues plus the output; chunked, the limbs beside either (the
    chunk's residues are folded into them before the output is made);
    plus the shifts; each tensor at the most the caching allocator counts
    for it. Complex: the largest of the moments in the module docstring,
    each tensor counted the same way: the operands' Re and Im parts and
    the shifts beside the residue GEMM's buffers (two slice sets a side, three with the
    Karatsuba sums, A's copies padded to kp, B's K-major, two residue
    sets), the Karatsuba sums of A's and of B's slices (their int16
    temporaries), the reconstruct's residues and two outputs, or the
    complex output beside its parts. The big-matrix strategy runs the
    classic 4-product kernel here, so it counts as CLASSIC. The signature
    has no operand or output word, so parts and outputs count 8 bytes a
    word: the complex128 figure, an over-count for complex64 and mixed
    calls. Complex calls have no chunked schedule."""
    L = num_moduli
    if compute_type in (ComputeType.REAL_DEFAULT, None):
        if moduli_chunk is not None and moduli_chunk < L:
            return _real_bytes(m, n, k, L, max(moduli_chunk, 1))
        return _real_bytes(m, n, k, L, None)
    if moduli_chunk is not None and moduli_chunk < L:
        raise ValueError("complex calls have no moduli-chunked schedule")
    return _complex_bytes(m, n, k, L,
                          compute_type == ComputeType.COMPLEX_KARATSUBA_MULT)


@dataclass(frozen=True)
class ModuliSchedule:
    """How the moduli loop is chunked for the low-memory mode."""

    num_moduli: int
    chunk: int  # moduli per materialized chunk

    @property
    def num_chunks(self) -> int:
        return math.ceil(self.num_moduli / self.chunk)

    def chunks(self):
        """[(first modulus, width)] of each chunk, in order."""
        return [(j, min(self.chunk, self.num_moduli - j))
                for j in range(0, self.num_moduli, self.chunk)]


def plan_schedule(m: int, n: int, k: int, num_moduli: int,
                  budget_bytes: int | None = None) -> ModuliSchedule:
    """Pick the moduli chunking: the largest chunk whose
    `workspace_bytes(..., moduli_chunk=chunk)` stays within budget_bytes,
    at least 1 (a budget below the limbs and one modulus cannot be met).
    None budget, or one the one-shot call fits: all moduli at once."""
    if budget_bytes is None or budget_bytes >= workspace_bytes(
            m, n, k, num_moduli):
        return ModuliSchedule(num_moduli, num_moduli)
    chunk = 1
    while chunk < num_moduli and workspace_bytes(
            m, n, k, num_moduli, moduli_chunk=chunk + 1) <= budget_bytes:
        chunk += 1
    return ModuliSchedule(num_moduli, chunk)


def plan_workspace(gemm_list) -> int:
    """Peak auxiliary bytes over a list of upcoming one-shot GEMMs. Entries:
    (m, n, k, num_moduli) or (m, n, k, num_moduli, compute_type)."""
    peak = 0
    for entry in gemm_list:
        m, n, k, num_moduli = entry[:4]
        ct = entry[4] if len(entry) > 4 else ComputeType.REAL_DEFAULT
        peak = max(peak, workspace_bytes(m, n, k, num_moduli, ct))
    return peak
