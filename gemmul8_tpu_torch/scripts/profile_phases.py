"""Per-kernel times on the card for the fast n^3 call.

Counterpart of `scripts/profile_phases.py`:

    python -m gemmul8_tpu_torch.scripts.profile_phases [n] [num_moduli]

(default 8192 14). A = phi_matrix(n, n, 0.5, seed=0) (the JAX script's
default_rng(0) draw) and B = A.T on the card. Each kernel of the fast
path runs through its `hopper/` wrapper, as `core.gemm.gemm_core` calls
it, timed with CUDA events over 10 launches after a warm-up: fast_sft on
A's rows and B's columns, encode_slices of both, matmul_mod_u8 (centered
residues), reconstruct; then their sum and its effective TFLOP/s
(2 n^3 / sum); then the counterparts of the JAX script's two XLA probes:
`torch._int_mm` over the L slice products (B column-major, no mod), and
over one. Each time is printed beside the SM clock and power draw
nvidia-smi sampled while it ran. The reconstructed output must have the
bits of `gemm` on the same operands. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse

import torch

ITERS = 10


def timeit(fn, *args, iters: int = ITERS):
    """(seconds per call by CUDA events after a warm-up, the warm-up's
    output, the ClockSampler that ran beside the timed calls)."""
    from ..bench.power import ClockSampler

    out = fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with ClockSampler() as clock:
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e-3 / iters, out, clock


def main(argv=None):
    """Run the profile; returns {"ms": {kernel: ms}, "clock": {kernel:
    (MHz, W)}, "sum_ms", "tflops", "out": the reconstructed output}."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.profile_phases")
    ap.add_argument("n", nargs="?", type=int, default=8192)
    ap.add_argument("num_moduli", nargs="?", type=int, default=14)
    args = ap.parse_args(argv)
    from ..api import gemm
    from ..bench.matrices import phi_matrix
    from ..bench.timing import require_gpu
    from ..hopper import kernels as hk
    from ..hopper import matmul as hm

    require_gpu()
    n, L = args.n, args.num_moduli
    A = torch.from_numpy(phi_matrix(n, n, 0.5, seed=0)).to("cuda")
    B = A.t().contiguous()
    ms, clocks = {}, {}

    def record(name, dt, clock, note=""):
        ms[name] = dt * 1e3
        clocks[name] = clock.medians()
        print(f"{name:<26}: {dt * 1e3:8.3f} ms{note} ({clock.summary()})",
              flush=True)

    dt, sft_a, clock = timeit(hk.fast_sft, A, L, 1)
    record("fast_sft A rows", dt, clock)
    dt, sft_b, clock = timeit(hk.fast_sft, B, L, 0)
    record("fast_sft B columns", dt, clock)
    dt, a8, clock = timeit(hk.encode_slices, A, sft_a, L, 1)
    record("encode_slices A", dt, clock)
    dt, b8, clock = timeit(hk.encode_slices, B, sft_b, L, 0)
    record("encode_slices B", dt, clock)
    dt, r8, clock = timeit(lambda x, y: hm.matmul_mod_u8(x, y, L,
                                                         centered=True),
                           a8, b8)
    record("matmul_mod_u8", dt, clock,
           f"  -> {2 * L * n ** 3 / dt / 1e12:6.1f} TOPS int8-equiv")
    dt, out, clock = timeit(hk.reconstruct, r8, sft_a, sft_b, L, "f64")
    record("reconstruct", dt, clock)
    total = sum(ms.values())
    tflops = 2 * n ** 3 / (total * 1e-3) / 1e12
    print(f"{'sum':<26}: {total:8.3f} ms -> {tflops:5.2f} TFLOP/s "
          "effective", flush=True)

    del r8
    b8t = b8.transpose(1, 2).contiguous()    # B's slices column-major
    dt, _, clock = timeit(lambda: [torch._int_mm(x, y.t())
                                   for x, y in zip(a8, b8t)])
    record(f"torch._int_mm x {L}", dt, clock,
           f"  -> {2 * L * n ** 3 / dt / 1e12:6.1f} TOPS")
    dt, _, clock = timeit(torch._int_mm, a8[0], b8t[0].t())
    record("torch._int_mm x 1", dt, clock,
           f"  -> {2 * n ** 3 / dt / 1e12:6.1f} TOPS")
    del a8, b8, b8t

    want = gemm(A, B, num_moduli=L)
    equal = torch.equal(out.view(torch.int64), want.view(torch.int64))
    print(f"output == gemm's output, bit for bit: {equal}", flush=True)
    if not equal:
        raise SystemExit("profile_phases: the kernels' output differs from "
                         "gemm's")
    return dict(ms=ms, clock=clocks, sum_ms=total, tflops=tflops, out=out)


if __name__ == "__main__":
    main()
