"""Large-problem throughput on the card: n^3 by the column-panel schedule
beside the one-shot call.

Counterpart of `scripts/scale_bench.py`:

    python -m gemmul8_tpu_torch.scripts.scale_bench [n] [n_panel]
        [num_moduli] [iters] [--outdir results_torch]

(default 16384 4096 14 5). A = phi_matrix(n, n, 0.5, seed=0) and B = A.T
on the card, fast mode. `gemm(A, B, n_panel=n_panel)` encodes A once and
streams B, its residues and the output n_panel columns at a time; an 80
GB card also holds the one-shot call at 16384^3 (about 7.5 GB of slices,
3.8 GB of residues and B's K-major copy), so both run: the panel call
must give the one-shot call's bits (the fast-mode contract of n_panel),
and one 256 x 256 tile is gated against the dd oracle (< 1e-8). Each call
is timed by the harness's protocol (`harness._fused_gemm_seconds`: the
whole call threaded by `chained_time`) and printed with TFLOP/s, its
ratio to the reference's GH200 OS2-fast-14 (72.13 TFLOP/s, BASELINE.md
section 1, unscaled), its peak device memory above what was allocated
before it, and the SM clock and power draw sampled while it was timed.
Writes the two rows to `oz2_results_d_scale_<card>_<stamp>.csv`. Exits
nonzero without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..bench import harness
from . import RESULTS_DIR

GH200_OS2_FAST_14 = 72.13      # TFLOP/s, BASELINE.md section 1
GATE = 1e-8
TILE = 256
FIELDS = harness.TIME_FIELDS + ["peak_bytes", "tile_max_relerr"]


def peak_call(fn):
    """(fn(), peak device bytes allocated during it above the bytes
    allocated before it)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def main(argv=None):
    """Run the bench; returns {"panel": row, "one_shot": row,
    "bits_equal": bool, "path": CSV path}."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.scale_bench")
    ap.add_argument("n", nargs="?", type=int, default=16384)
    ap.add_argument("n_panel", nargs="?", type=int, default=4096)
    ap.add_argument("num_moduli", nargs="?", type=int, default=14)
    ap.add_argument("iters", nargs="?", type=int, default=5)
    ap.add_argument("--outdir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    from ..api import gemm
    from ..bench.matrices import phi_matrix
    from ..bench.native import dd_gemm, relerr_vs_dd
    from ..bench.power import ClockSampler
    from ..bench.timing import require_gpu

    require_gpu()
    n, n_panel, L = args.n, args.n_panel, args.num_moduli
    a = phi_matrix(n, n, 0.5, seed=0)
    A = torch.from_numpy(a).to("cuda")
    B = A.t().contiguous()
    ref_hi, ref_lo = dd_gemm(a[:TILE], np.ascontiguousarray(a.T[:, :TILE]))
    calls = {"panel": dict(n_panel=n_panel), "one_shot": {}}
    out, bits = {}, {}
    for name, kw in calls.items():
        c, peak = peak_call(lambda kw=kw: gemm(A, B, num_moduli=L, **kw))
        rel, _ = relerr_vs_dd(c[:TILE, :TILE].cpu().numpy(), ref_hi, ref_lo)
        bits[name] = c.view(torch.int64)
        with ClockSampler() as clock:
            dt = harness._fused_gemm_seconds(A, B, L, True, args.iters, **kw)
        mhz, draw = clock.medians()
        tflops = 2 * n ** 3 / dt / 1e12
        label = (f"OS2-fast-{L}-panel{n_panel}" if kw
                 else f"OS2-fast-{L}")
        out[name] = dict(
            phi=0.5, m=n, n=n, k=n, func=label, seconds=dt, tflops=tflops,
            t_scale=np.nan, t_int8gemm=np.nan, t_mod=np.nan,
            t_invscale=np.nan, sm_mhz=mhz, power_draw_w=draw,
            peak_bytes=peak, tile_max_relerr=rel)
        print(f"{n}^3 L={L} {'panel=' + str(n_panel) if kw else 'one-shot'}"
              f": {dt * 1e3:.3f} ms -> {tflops:.2f} TFLOP/s = "
              f"{tflops / GH200_OS2_FAST_14:.3f}x GH200 OS2-fast-14 "
              f"{GH200_OS2_FAST_14} (unscaled); peak {peak} bytes "
              f"({peak / 2 ** 30:.2f} GiB); tile relerr {rel:.3e}; SM clock "
              f"median {mhz:.0f} MHz, power draw median {draw:.1f} W",
              flush=True)
        if not rel < GATE:
            raise SystemExit(f"scale_bench: {name} tile relerr {rel:.3e} "
                             f">= {GATE}")
    equal = torch.equal(bits["panel"], bits["one_shot"])
    print(f"panel call == one-shot call, bit for bit: {equal}", flush=True)
    if not equal:
        raise SystemExit("scale_bench: the n_panel call's bits differ from "
                         "the one-shot call's")
    path = harness._csv_path("d_scale", args.outdir)
    harness._write_rows(list(out.values()), path, FIELDS)
    print(f"-> {path}", flush=True)
    return dict(out, bits_equal=equal, path=path)


if __name__ == "__main__":
    main()
