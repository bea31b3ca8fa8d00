"""The least time the card could take for a kernel's work: its bound.

The larger of two times: the bytes the work must move (each input read
once, each output written once) at the card's device-memory rate, and
its int8 tensor-core operations at their peak rate. The rates are the
H100 SXM5 data sheet's dense peaks, at the full 700 W power limit; a card
set below it runs slower under load, so a share of the bound is stated
beside the card's power limit. Integer and f32 ALU work is not counted
(no published peak; it is below the byte bound of these kernels).

`chip_smoke.py` writes these bounds into its kernels line (`bound_ms`,
`bound_by`) and `PERF.md` §6 reads them; the tuners
(`gemmul8_tpu_torch.scripts.tune_kernels`) give each candidate's share
of the same bound.
"""

from __future__ import annotations

import math

from .. import tables

# device-memory bytes per second and int8 tensor-core operations per
# second of the H100 SXM5 (data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound(nbytes, ops=0):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of nbytes of device memory at HBM_BYTES_PER_S and ops int8
    tensor-core operations at INT8_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bounds(a, b, L, panel_m=1024):
    """bound() of each kernel's main-path work on f64 operands a (m, k)
    and b (k, n) (anything with a shape), each input read once and each
    output written once: both operands where the path runs the kernel
    twice; the complex GEMM in its 4-dot form on parts of these shapes;
    the pipeline's kernels on one panel of panel_m rows."""
    m, k = a.shape
    n = b.shape[1]
    pm = panel_m
    x = math.prod(a.shape) + math.prod(b.shape)  # f64 elements of both
    s = 4 * (m + n)                  # int32 shifts, exponents or maxima
    ops = 2 * m * n * k              # int8 operations of one product
    slices = L * (m * k + k * n)     # int8 residues of both operands
    return {
        "fast_sft": bound(8 * x + s),
        "encode_slices": bound(8 * x + s + L * x),
        "matmul_mod_u8": bound(slices + L * m * n, L * ops),
        "reconstruct": bound(L * m * n + s + 8 * m * n),
        "emax": bound(8 * x + s),
        "mag7": bound(8 * x + s + x),
        "magmax_matmul": bound(x + s, ops),
        "matmul_complex_mod": bound(2 * slices + 2 * L * m * n, 4 * L * ops),
        "fast_encode_fused": bound(8 * x + L * x + s),
        "mag7_fused": bound(8 * x + x + s),
        "magmax_matmul_scratch": bound(x + s, ops),
        "matmul_mod_u8_pipelined": bound(slices + L * m * n, L * ops),
        "matmul_crt": bound(slices + 4 * tables.num_limbs(L) * m * n,
                            L * ops),
        "matmul_reconstruct": bound(slices + s + 8 * m * n, L * ops),
        # not a kernel of its own: reconstruct on its limb input
        "reconstruct (limbs)": bound(4 * tables.num_limbs(L) * m * n + s
                                     + 8 * m * n),
        # both riders: A's panel slices, B, the previous panel's residues,
        # the next panel's f64 rows and the shifts read; the residues, the
        # previous panel's f64 rows and the next panel's slices written
        "matmul_rider_step": bound(
            L * (pm * k + k * n + pm * n) + L * pm * n + 8 * pm * n
            + 8 * pm * k + L * pm * k + 4 * (3 * pm + n), L * 2 * pm * n * k),
        # with the A-panel-1 rider: panel 0's slices, B's left-half slices
        # and B's right half in f64 read; the residues, all of B's slices
        # (K-major) and A-panel 1's slices written
        "matmul_bsplit_pair": bound(
            L * pm * k + L * k * (n // 2) + 8 * k * (n // 2) + L * pm * n
            + L * k * n + 8 * pm * k + L * pm * k + 4 * (2 * pm + n),
            L * 2 * pm * n * k),
        "reconstruct_into": bound(L * pm * n + 4 * (pm + n) + 8 * pm * n),
    }
