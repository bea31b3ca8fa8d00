"""Mesh-sharded emulated DGEMM across the ranks of a world.

Counterpart of `examples/distributed_gemm.py`: a 2-D mesh of the world's
ranks (`parallel/distributed.make_mesh`), per-rank encode and int8
residue GEMMs, one exact all-to-all of uint8 residues, the CRT on the
owning rank (`gemm_sharded`). Under torchrun (or the GEMMUL8_* variables,
`parallel/multihost.py`) the world is the launched ranks, one card each
on NCCL; without a launcher, a world of one on the card. `--device cpu`
runs gloo ranks on the CPU (the plain versions):

    torchrun --nproc-per-node 4 -m gemmul8_tpu_torch.examples.distributed_gemm
    python -m gemmul8_tpu_torch.examples.distributed_gemm [--device cpu]

Rank 0 prints the max relerr of the assembled product against numpy's and
whether it is bit-equal to `gemm` on the whole problem in one process.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Returns (max relerr, bit-equal to gemm) on rank 0, None on the
    others."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.examples.distributed_gemm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from .. import gemm
    from ..parallel import distributed as sd
    from ..parallel import multihost
    from ..parallel.smoke import free_port

    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    else:
        from ..bench.timing import require_gpu

        require_gpu()
    if not multihost.initialize_from_env(force_cpu=cpu):
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        mesh = sd.make_mesh()
        nx, ny = mesh.nx, mesh.ny
        if mesh.rank == 0:
            print(f"ranks: {dist.get_world_size()} ({mesh.backend}), mesh "
                  f"{nx}x{ny}")
        m, k, n = 64 * nx, 256 * ny, 64 * ny
        rng = np.random.default_rng(0)
        a = (rng.random((m, k)) - 0.5) * np.exp(rng.standard_normal((m, k))
                                               * 0.5)
        b = (rng.random((k, n)) - 0.5) * np.exp(rng.standard_normal((k, n))
                                               * 0.5)
        tile = sd.gemm_sharded(sd.shard_of(a, mesh, ("x", "y")),
                               sd.shard_of(b, mesh, ("y", "x")), mesh,
                               num_moduli=14)
        tiles = [None] * dist.get_world_size()
        dist.all_gather_object(tiles, tile.cpu().numpy())
        out = None
        if mesh.rank == 0:
            got = sd.assemble(tiles, mesh).numpy()
            rel = np.abs(got - a @ b) / np.maximum(np.abs(a @ b), 1e-300)
            full = gemm(a, b, num_moduli=14,
                        device=mesh.device).cpu().numpy()
            equal = bool(np.array_equal(got.view(np.int64),
                                        full.view(np.int64)))
            print(f"sharded emulated DGEMM ({m}x{k}x{n}): max relerr "
                  f"{rel.max():.2e}; bit-equal to gemm: {equal}")
            out = (float(rel.max()), equal)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
