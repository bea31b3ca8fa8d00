"""A right-looking blocked LU factorisation without pivoting, its trailing
updates on the emulated DGEMM.

    python -m gemmul8_tpu_torch.examples.blocked_lu [--n 16384] [--nb 512]
        [--moduli 14] [--device cuda|cpu]

The matrix is a phi = 0.5 phi-matrix plus n on its diagonal: diagonally
dominant, so the factorisation needs no row swaps. Each block step is
LAPACK dgetrf's without its pivoting: the panel A[j:, j:j+nb] factored
column by column and U12 = L11^-1 A12 by a triangular solve, both in plain
torch float64; then the trailing update A22 <- A22 - A21 U12 through
`gemmul8_tpu_torch.gemm(A21, U12, alpha=-1, beta=1, c=A22)` on views of
the matrix (leading dimension n), its result copied back into A22, since
the port returns a new C where dgetrf overwrites A22.

The factors (L's unit lower triangle and U in one matrix) are compared
with the same loop whose updates run `torch.matmul` in float64: the
widest gap as a share of the widest element. On the card each update is
also timed by CUDA events: the call on the views, the copy back into A22,
and the same call on contiguous copies of its operands, as the
benchmark's cell `dgemm14-lu16384` makes them. `core.gemm.OPERAND_COPIES`
counts, under `trace.recording()`, the copies of operands that came as
views. One JSON line is printed: the sizes, the gap, the copies and the
times summed over the updates (each update's in "updates").
"""

from __future__ import annotations

import argparse
import json


def factor(a, nb: int, update):
    """a (n, n) overwritten by its LU factors without pivoting, blocks of
    nb columns; update(a21, a12, a22) overwrites A22 by A22 - A21 A12."""
    import torch

    n = a.shape[0]
    for j in range(0, n, nb):
        e = min(j + nb, n)
        for i in range(j, e):
            a[i + 1:, i] /= a[i, i]
            a[i + 1:, i + 1:e] -= torch.outer(a[i + 1:, i], a[i, i + 1:e])
        if e < n:
            a[j:e, e:] = torch.linalg.solve_triangular(
                a[j:e, j:e], a[j:e, e:], upper=False, unitriangular=True)
            update(a[e:, j:e], a[j:e, e:], a[e:, e:])
    return a


def matmul_update(a21, a12, a22):
    a22.sub_(a21 @ a12)


def emulated_update(num_moduli: int, times: list | None = None):
    """The update through `gemmul8_tpu_torch.gemm` on the views, its
    result copied into A22. With `times` (on the card), each update's
    CUDA-event times in ms are appended: the call on the views, the copy
    back, and the call on contiguous copies of the operands."""
    import torch

    from .. import gemm

    def call(a21, a12, a22):
        return gemm(a21, a12, alpha=-1.0, beta=1.0, c=a22,
                    num_moduli=num_moduli, fastmode=True)

    def ms(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        t1.synchronize()
        return out, t0.elapsed_time(t1)

    def update(a21, a12, a22):
        if times is None:
            a22.copy_(call(a21, a12, a22))
            return
        out, view_ms = ms(lambda: call(a21, a12, a22))
        _, copy_ms = ms(lambda: a22.copy_(out))
        operands = [x.contiguous() for x in (a21, a12, a22)]
        _, contig_ms = ms(lambda: call(*operands))
        times.append({"m": a22.shape[0], "view_ms": view_ms,
                      "copy_ms": copy_ms, "contig_ms": contig_ms})
    return update


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.examples.blocked_lu")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--moduli", type=int, default=14)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch

    from .. import trace
    from ..bench.matrices import phi_matrix
    from ..core import gemm as core_gemm

    on_card = args.device == "cuda"
    if on_card:
        from ..bench.timing import require_gpu

        require_gpu()
    n = args.n
    a0 = torch.from_numpy(phi_matrix(n, n, 0.5, seed=0)).to(args.device)
    a0.diagonal().add_(float(n))
    want = factor(a0.clone(), args.nb, matmul_update)
    times = []
    update = emulated_update(args.moduli, times if on_card else None)
    core_gemm.OPERAND_COPIES.clear()
    with trace.recording():
        got = factor(a0.clone(), args.nb, update)
    copies = dict(core_gemm.OPERAND_COPIES)
    gap = float((got - want).abs().max() / want.abs().max())
    out = {"device": torch.cuda.get_device_name() if on_card else "cpu",
           "n": n, "nb": args.nb, "moduli": args.moduli, "gap": gap,
           "operand_copies": copies}
    if times:
        for key in ("view_ms", "contig_ms", "copy_ms"):
            out[key] = sum(t[key] for t in times)
        out["updates"] = times
    print(json.dumps(out))
    return {"factors": got, "matmul_factors": want, **out}


if __name__ == "__main__":
    main()
