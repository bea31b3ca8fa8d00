"""Weak-scaling harness for the sharded emulated GEMM
(`parallel/distributed.gemm_sharded`).

Counterpart of `scripts/weak_scaling.py`: emulated-DGEMM TFLOP/s per rank
with the problem grown with the world (each rank's tile fixed at base x
base: m = base nx, n = base ny on an nx x ny mesh; global k = min(8 base,
2^17)), fast mode.

    python -m gemmul8_tpu_torch.scripts.weak_scaling [--base 512]
        [--moduli 14] [--iters 3] [--repeats 5] [--csv PATH]
        [--device cuda|cpu] [--ranks N]

Alone, it launches a world of 1, 2, 4, ... ranks up to N (the ladder of
the JAX script; --ranks defaults to the cards present on cuda and to 4
gloo CPU ranks on cpu), one process a rank through the GEMMUL8_*
variables (`parallel/multihost.py`), and rank 0 of each world reports
its row. On cuda each rank needs a card of its own (NCCL). Under a
launcher (torchrun, or the GEMMUL8_* variables set) it measures the
launched world alone, since every rank owns one mesh position.

Each point: `repeats` trials of `iters` chained calls, the median kept
with the min and max. Every world's tiles must be bit-equal to `gemm` on
the whole problem in one process. On gloo CPU ranks neither per-rank nor
aggregate throughput measures scaling (the ranks share the host's
cores), so each row also carries the JAX script's honest metric for such
runs: the same global problem by `gemm` in rank 0's process, and
sharded / unsharded on identical work (`efficiency_vs_unsharded`), a
crude lower bound on collective efficiency. The CSV has the JAX script's
columns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

_TIMEOUT = 3600


def operands(base: int, nx: int, ny: int):
    """The global (m, k) and (k, n) f64 operands of an nx x ny mesh
    point, from default_rng(0) as the JAX script draws them."""
    m, n = base * nx, base * ny
    k = min(base * 8, 1 << 17)
    rng = np.random.default_rng(0)
    a = (rng.random((m, k)) - .5) * np.exp(rng.standard_normal((m, k)) * .5)
    b = (rng.random((k, n)) - .5) * np.exp(rng.standard_normal((k, n)) * .5)
    return a, b


def _sync(t) -> None:
    import torch

    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def trial_median(fn, iters: int, repeats: int):
    """(median seconds per call over `repeats` trials of `iters` chained
    calls after a warm-up, the trials)."""
    _sync(fn())
    trials = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        _sync(out)
        trials.append((time.perf_counter() - t0) / iters)
    return float(np.median(trials)), trials


def measure(base: int, num_moduli: int, iters: int, repeats: int):
    """This rank's part of one world's point; rank 0 returns the row (the
    others None). Raises unless the assembled tiles equal `gemm`'s output
    bit for bit."""
    import torch.distributed as dist

    from ..api import gemm
    from ..parallel import distributed as sd

    mesh = sd.make_mesh()
    nx, ny = mesh.nx, mesh.ny
    a, b = operands(base, nx, ny)
    m, k = a.shape
    n = b.shape[1]
    ash = sd.shard_of(a, mesh, ("x", "y"))
    bsh = sd.shard_of(b, mesh, ("y", "x"))

    def call():
        return sd.gemm_sharded(ash, bsh, mesh, num_moduli=num_moduli)

    dt, trials = trial_median(call, iters, repeats)
    tiles = [None] * dist.get_world_size()
    dist.all_gather_object(tiles, call().cpu().numpy())
    row = None
    if mesh.rank == 0:
        full = gemm(a, b, num_moduli=num_moduli, device=mesh.device)
        got = sd.assemble(tiles, mesh).numpy()
        if not np.array_equal(got.view(np.int64),
                              full.cpu().numpy().view(np.int64)):
            raise AssertionError(f"mesh {nx}x{ny}: the sharded tiles differ "
                                 "from gemm's output")
        print(f"mesh {nx}x{ny}: every tile bit-equal to gemm on the whole "
              f"{m} x {k} x {n} problem", flush=True)
        tflops = 2 * m * n * k / dt / 1e12
        row = dict(devices=nx * ny, mesh=f"{nx}x{ny}", m=m, n=n, k=k,
                   seconds=dt, seconds_min=float(np.min(trials)),
                   seconds_max=float(np.max(trials)), trials=repeats,
                   tflops=tflops, tflops_per_chip=tflops / (nx * ny))
        if mesh.backend == "gloo" and mesh.device.type == "cpu":
            # the same global problem unsharded in one process: the
            # sharded / unsharded ratio isolates what the collectives cost
            # on identical work
            dt1, _ = trial_median(
                lambda: gemm(a, b, num_moduli=num_moduli,
                             device=mesh.device), iters, repeats)
            row["seconds_unsharded_1dev"] = dt1
            row["efficiency_vs_unsharded"] = dt1 / dt
    dist.barrier()
    return row


def launched_world() -> bool:
    """Whether this process is a rank of a launched world (torchrun, or
    the GEMMUL8_* variables)."""
    from ..parallel import multihost

    return (any(v in os.environ for v in (multihost._ENV_COORD,
                                          multihost._ENV_NPROC,
                                          multihost._ENV_PROCID))
            or multihost._on_pod())


def run_rank(args) -> dict:
    """Join the launched world, measure, return rank 0's row (None on
    the other ranks); with --row-out, rank 0 writes it there as JSON."""
    import torch
    import torch.distributed as dist

    from ..parallel import multihost

    if args.device == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    if not multihost.initialize_from_env(force_cpu=args.device == "cpu"):
        raise SystemExit("weak_scaling: no launched world")
    try:
        row = measure(args.base, args.moduli, args.iters, args.repeats)
    finally:
        dist.destroy_process_group()
    if row is not None and args.row_out:
        with open(args.row_out, "w") as f:
            json.dump(row, f)
    return row


def launch_world(nproc: int, argv, row_out: str) -> None:
    """Run a world of nproc ranks of this module (one process each) on a
    free local port; raise if a rank fails."""
    from ..parallel.smoke import launch_world as launch

    codes = launch(["-m", "gemmul8_tpu_torch.scripts.weak_scaling", *argv,
                    "--row-out", row_out], nproc, _TIMEOUT)
    if any(codes):
        raise SystemExit(f"weak_scaling: a world of {nproc} ranks failed: "
                         f"exit codes {codes}")


def ladder(n_max: int):
    """1, 2, 4, ... up to n_max, and n_max itself."""
    sizes, d = [], 1
    while d <= n_max:
        sizes.append(d)
        d *= 2
    if sizes and sizes[-1] != n_max:
        sizes.append(n_max)
    return sizes


def report(rows, repeats: int, virtual: bool) -> None:
    for r in rows:
        spread = (r["seconds_max"] - r["seconds_min"]) / r["seconds"] * 100
        extra = ""
        if "efficiency_vs_unsharded" in r:
            extra = (f"  sharded/unsharded eff "
                     f"{r['efficiency_vs_unsharded'] * 100:.1f}%")
        rate = (f"{r['seconds'] * 1e3:.3f} ms a call on gloo CPU ranks"
                if virtual else
                f"{r['tflops']:.3f} TFLOP/s total, "
                f"{r['tflops_per_chip']:.3f}/chip")
        print(f"{r['devices']:3d} dev ({r['mesh']}): {rate} (median of "
              f"{r['trials']}, spread {spread:.0f}%){extra}", flush=True)
    if len(rows) > 1:
        if virtual:
            effs = [r["efficiency_vs_unsharded"] for r in rows[1:]]
            print("gloo CPU ranks' collective-overhead efficiency "
                  f"(sharded/unsharded, median-of-{repeats}): min "
                  f"{min(effs) * 100:.1f}% over {len(effs)} mesh points")
        else:
            eff = rows[-1]["tflops_per_chip"] / rows[0]["tflops_per_chip"]
            print(f"weak-scaling per-chip efficiency {rows[0]['devices']}->"
                  f"{rows[-1]['devices']} devices: {eff * 100:.1f}%")
        for r in rows:
            r["metric"] = ("sharded_vs_unsharded" if virtual
                           else "per_chip")


def write_csv(rows, path: str) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {path}")


def main(argv=None):
    """Run the ladder (or this rank of a launched world); returns the
    rows (rank 0) or []."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.weak_scaling")
    ap.add_argument("--base", type=int, default=512,
                    help="per-rank tile edge")
    ap.add_argument("--moduli", type=int, default=14)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5,
                    help="independent trials per mesh point (median kept)")
    ap.add_argument("--csv", type=str, default=None,
                    help="write rows to this CSV path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="the largest world of the ladder")
    ap.add_argument("--row-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    virtual = args.device == "cpu"
    if args.device == "cuda":
        from ..bench.timing import require_gpu

        require_gpu()
    if launched_world():
        row = run_rank(args)
        if args.row_out:        # a world of the ladder: its parent reports
            return [row] if row is not None else []
        rows = [row] if row is not None else []
    else:
        import torch

        n_max = args.ranks or (4 if virtual else torch.cuda.device_count())
        child = [a for i, a in enumerate(argv)
                 if a != "--csv" and (i == 0 or argv[i - 1] != "--csv")]
        rows = []
        with tempfile.TemporaryDirectory() as tmp:
            for nd in ladder(n_max):
                path = os.path.join(tmp, f"row{nd}.json")
                launch_world(nd, child, path)
                with open(path) as f:
                    rows.append(json.load(f))
    if not rows:
        return []
    report(rows, args.repeats, virtual)
    if args.csv:
        write_csv(rows, args.csv)
    return rows


if __name__ == "__main__":
    main()
