"""Single-call complex smoke test.

Counterpart of `examples/one_accuracy_complex.py` (the reference's
one_accuracy_complex.cu:9,66-67): complex64 512^3, phi 0.5, the
Karatsuba strategy in accurate mode at 15 moduli; max and median relerr
of the native CGEMM (numpy's complex64 product) and of the emulation
against the complex128 product of the operands.

    python -m gemmul8_tpu_torch.examples.one_accuracy_complex [--n 512]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

NUM_MODULI = 15
N = 512


def main(argv=None):
    """Print both lines; returns {"CGEMM": (max, med), "OS2": (max,
    med)}."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.examples.one_accuracy_complex")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)
    from .. import ComputeType, gemm
    from ..bench.matrices import phi_matrix

    n = args.n
    a = (phi_matrix(n, n, 0.5, 1) + 1j * phi_matrix(n, n, 0.5, 2)).astype(
        np.complex64)
    b = (phi_matrix(n, n, 0.5, 3) + 1j * phi_matrix(n, n, 0.5, 4)).astype(
        np.complex64)
    ref = a.astype(np.complex128) @ b.astype(np.complex128)
    c = gemm(a, b, num_moduli=NUM_MODULI, fastmode=False,
             compute_type=ComputeType.COMPLEX_KARATSUBA_MULT,
             device=args.device).cpu().numpy()
    err = np.abs(c.astype(np.complex128) - ref) / np.abs(ref)
    nerr = np.abs((a @ b).astype(np.complex128) - ref) / np.abs(ref)
    out = {"CGEMM": (float(nerr.max()), float(np.median(nerr))),
           "OS2": (float(err.max()), float(np.median(err)))}
    print(f"CGEMM        max relerr {out['CGEMM'][0]:.3e}  med "
          f"{out['CGEMM'][1]:.3e}")
    print(f"OS2-kara-{NUM_MODULI}  max relerr {out['OS2'][0]:.3e}  med "
          f"{out['OS2'][1]:.3e}")
    return out


if __name__ == "__main__":
    main()
