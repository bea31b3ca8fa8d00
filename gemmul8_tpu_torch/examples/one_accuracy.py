"""Single-call smoke test: SGEMM emulation relative error printout.

Counterpart of `examples/one_accuracy.py` (the reference's
testing/one_accuracy.cu:7-80): one f32 1024^3 phi = 0.5 call at 15
moduli, fast mode, seeds 123456 and 123457; max and median relerr of the
native SGEMM (numpy's f32 product) and of the emulation against the dd
oracle of the operands widened to f64.

    python -m gemmul8_tpu_torch.examples.one_accuracy [--n 1024]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

NUM_MODULI = 15
PHI = 0.5
N = 1024


def main(argv=None):
    """Print both lines; returns {"SGEMM": (max, med), "OS2": (max,
    med)}."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.examples.one_accuracy")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)
    from .. import gemm
    from ..bench.matrices import phi_matrix, relerr_stats
    from ..bench.native import dd_gemm

    a = phi_matrix(args.n, args.n, PHI, seed=123456).astype(np.float32)
    b = phi_matrix(args.n, args.n, PHI, seed=123457).astype(np.float32)
    ref = dd_gemm(a.astype(np.float64), b.astype(np.float64))[0]
    c = gemm(a, b, num_moduli=NUM_MODULI, fastmode=True,
             device=args.device).cpu().numpy()
    mx, med = relerr_stats(c.astype(np.float64), ref)
    nx, nmed = relerr_stats((a @ b).astype(np.float64), ref)
    print(f"SGEMM   max relerr {nx:.3e}  med {nmed:.3e}")
    print(f"OS2-{NUM_MODULI}  max relerr {mx:.3e}  med {med:.3e}")
    return {"SGEMM": (nx, nmed), "OS2": (mx, med)}


if __name__ == "__main__":
    main()
