"""Multi-seed accuracy sweep at the reference scale.

Counterpart of `scripts/band_seed_sweep.py`: runs the k = 8192 band
protocol (m = n = 1024, phi = 0.5; test_double.cu:19-23) at several seeds
to measure the seed-to-seed spread of the max-relerr statistic that
tests/test_scale_bands.py's slack factor must cover. Seeds 123456 + 10 s
and 123457 + 10 s; ground truth the dd oracle. Run:

    python -m gemmul8_tpu_torch.scripts.band_seed_sweep --seeds 3 \\
        [--moduli 10 12 13 14 15 16] [--device cuda|cpu] \\
        [--csv results_torch/band_seed_sweep_<card>.csv]
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

M, K = 1024, 8192
MODULI = (10, 12, 13, 14, 15, 16)


def sweep(seeds: int = 3, moduli=MODULI, m: int = M, k: int = K,
          device="cuda"):
    """Rows {seed, mode, moduli, max_relerr, med_relerr}, seed by seed,
    fast then accurate mode, each L of `moduli`; printed as they come."""
    from ..api import gemm
    from ..bench.matrices import phi_matrix
    from ..bench.native import dd_gemm, relerr_vs_dd

    rows = []
    for s in range(seeds):
        sa, sb = 123456 + 10 * s, 123457 + 10 * s
        a = phi_matrix(m, k, 0.5, seed=sa)
        b = phi_matrix(k, m, 0.5, seed=sb)
        ref_hi, ref_lo = dd_gemm(a, b)
        for fast in (True, False):
            for L in moduli:
                c = gemm(a, b, num_moduli=L, fastmode=fast,
                         device=device).cpu().numpy()
                mx, med = relerr_vs_dd(c.astype(np.float64), ref_hi, ref_lo)
                rows.append(dict(seed=sa, mode="fast" if fast else "accu",
                                 moduli=L, max_relerr=mx, med_relerr=med))
                print(f"seed {sa} {'fast' if fast else 'accu'}-{L}: "
                      f"max {mx:.3e} med {med:.3e}", flush=True)
    return rows


def spread(rows, moduli=MODULI) -> float:
    """Print the spread (max over seeds / min over seeds) of max_relerr
    per (mode, L); returns the worst spread above the 1e-13 floor, where
    relerr is cancellation luck."""
    print("\nseed spread (max over seeds / min over seeds) of max_relerr:")
    worst = 1.0
    for mode in ("fast", "accu"):
        for L in moduli:
            vals = [r["max_relerr"] for r in rows
                    if r["mode"] == mode and r["moduli"] == L]
            lo, hi = min(vals), max(vals)
            sp = hi / lo if lo > 0 else float("inf")
            if hi > 1e-13:
                worst = max(worst, sp)
            print(f"  {mode}-{L}: {sp:.2f}x  ({lo:.3e} .. {hi:.3e})")
    print(f"worst spread above the 1e-13 floor: {worst:.2f}x")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.band_seed_sweep")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--moduli", type=int, nargs="*", default=list(MODULI))
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from ..bench.timing import require_gpu

        require_gpu()
    rows = sweep(args.seeds, args.moduli, M, K, device=args.device)
    worst = spread(rows, args.moduli)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return rows, worst


if __name__ == "__main__":
    main()
