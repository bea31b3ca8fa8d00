"""Throughput sweep on the card for the evidence CSVs.

Counterpart of `scripts/time_sweep_tpu.py`:

    python -m gemmul8_tpu_torch.scripts.time_sweep [sizes] [d|f|md|mf|all]
        [--outdir results_torch]

sizes: comma-separated, default 4096,8192; mode default d.
  d      OS2-fast-14 and OS2-accu-14 (with the axpby row), the native
         DGEMM, the INT8-GEMM probe and OS1-EF-8 / 9;
  f      OS2-{fast,accu}-6 and -8, SGEMM, INT8-GEMM and BF16X3-SCALING;
  md/mf  the mixed protocols (test_mixed_double / test_mixed_float) at 14
         moduli, both modes.
Every row is timed by `harness.time_check` (iters 10, phi 0.5) and
carries the SM clock and power draw (`sm_mhz`, `power_draw_w`) sampled
while it was timed. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse

from ..bench import harness
from . import RESULTS_DIR

SHOWN = ("m", "func", "seconds", "tflops", "sm_mhz", "power_draw_w")

# scripts/time_sweep_tpu.py: (mode, time_check keywords)
PROTOCOLS = [
    ("d", dict(dtype="d", num_moduli=(14,), fastmodes=(True, False),
               phi=0.5, iters=10, include_osi=(8, 9))),
    ("f", dict(dtype="f", num_moduli=(6, 8), fastmodes=(True, False),
               phi=0.5, iters=10)),
    ("md", dict(dtype="md", num_moduli=(14,), fastmodes=(True, False),
                phi=0.5, iters=10)),
    ("mf", dict(dtype="mf", num_moduli=(14,), fastmodes=(True, False),
                phi=0.5, iters=10)),
]


def main(argv=None):
    """Run the sweep; returns {mode: (rows, CSV path)}."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.time_sweep")
    ap.add_argument("sizes", nargs="?", default="4096,8192")
    ap.add_argument("which", nargs="?", default="d",
                    choices=["d", "f", "md", "mf", "all"])
    ap.add_argument("--outdir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.sizes.split(","))
    from ..bench.timing import require_gpu

    require_gpu()
    out = {}
    for mode, kw in PROTOCOLS:
        if args.which not in (mode, "all"):
            continue
        rows, path = harness.time_check(sizes=sizes, outdir=args.outdir,
                                        **kw)
        for r in rows:
            print({key: r[key] for key in SHOWN}, flush=True)
        print(f"-> {path}", flush=True)
        out[mode] = (rows, path)
    return out


if __name__ == "__main__":
    main()
