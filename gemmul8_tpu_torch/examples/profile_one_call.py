"""A bare repeated emulated-DGEMM call under `torch.profiler`.

Counterpart of `examples/profile_one_call.py` (the reference's
testing/profile_one_call.cu:5-9): one isolated n^3 fast-mode call at 14
moduli (A = phi_matrix(n, n, 0.5, seed=0), the JAX example's
default_rng(0) draw, B = A.T), loopable:

    python -m gemmul8_tpu_torch.examples.profile_one_call [--n 8192]
        [--moduli 14] [--iters 5] [--trace-dir DIR] [--device cuda|cpu]

After a warm-up call, `iters` calls run inside `torch.profiler.profile`
(CPU and, on the card, CUDA activities); the table of `key_averages()` is
printed by kernel (device time first on the card), and with --trace-dir
the Chrome trace is written there (`profile_one_call.json`, for
chrome://tracing or Perfetto). Then the per-call time of `iters` more
calls, outside the profiler: by CUDA events on the card, by the host
clock on the CPU. Where the profiler records no device time on the card,
a line says so.
"""

from __future__ import annotations

import argparse
import os
import time

TRACE_NAME = "profile_one_call.json"


def main(argv=None):
    """Returns {"ms": per-call ms, "device_us": the profile's summed
    self device time in us (0 on the CPU), "trace": the trace's path or
    None, "table": the printed table}."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.examples.profile_one_call")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--moduli", type=int, default=14)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace-dir", default=None,
                    help="write the profiler's Chrome trace here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import gemm
    from ..bench.matrices import phi_matrix

    on_card = args.device == "cuda"
    if on_card:
        from ..bench.timing import require_gpu

        require_gpu()
    n = args.n
    A = torch.from_numpy(phi_matrix(n, n, 0.5, seed=0)).to(args.device)
    B = A.t().contiguous()

    def call():
        return gemm(A, B, num_moduli=args.moduli)

    def fence():
        if on_card:
            torch.cuda.synchronize()

    call()
    fence()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(args.iters):
            call()
        fence()
    events = prof.key_averages()
    sort = "self_cuda_time_total" if on_card else "self_cpu_time_total"
    table = events.table(sort_by=sort, row_limit=15)
    print(table)
    device_us = (sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     for e in events) if on_card else 0.0)
    if on_card and device_us <= 0:
        print("profiler: key_averages() shows no CUDA device time on this "
              "host (time by CUDA events below)")
    trace = None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace = os.path.join(args.trace_dir, TRACE_NAME)
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}")
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            call()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / args.iters
        print(f"{ms:.3f} ms/call (CUDA events, {args.iters} calls) -> "
              f"{2 * n ** 3 / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
              f"({torch.cuda.get_device_name()})")
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            call()
        ms = (time.perf_counter() - t0) * 1e3 / args.iters
        print(f"{ms:.3f} ms/call (host clock, the CPU's plain versions, "
              f"{args.iters} calls)")
    return dict(ms=ms, device_us=device_us, trace=trace, table=table)


if __name__ == "__main__":
    main()
