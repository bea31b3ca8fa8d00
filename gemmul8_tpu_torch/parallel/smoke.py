"""Multi-process smoke of the sharded engine on CPU ranks, and its dry run.

Counterpart of `scripts/multihost_smoke.py` and of the JAX package's
multi-chip dry run (`__graft_entry__.dryrun_multichip`):

    python -m gemmul8_tpu_torch.parallel.smoke              # 2 gloo ranks
    python -m gemmul8_tpu_torch.parallel.smoke --dryrun 4   # 4 gloo ranks
    python -m gemmul8_tpu_torch.parallel.smoke --gloo-cuda 2

The first launches two worker processes through the GEMMUL8_* variables
on a free local port (`multihost.initialize_from_env(force_cpu=True)`);
each runs `gemm_sharded` on its shards of one 32^3 product, checks its
own tile against numpy and prints `multihost smoke OK`. `--dryrun N` runs
the dry run's cases on N gloo ranks (fast and accurate f64, n_panel, f32,
f64 x f32, the three complex strategies, complex128 x complex64), holds
them to the JAX dry run's bounds and prints one line in its format, with
the JAX package's figures beside it. `--gloo-cuda N` asks gloo, on N
ranks that share cuda:0, for the engine's three collectives on CUDA
tensors and prints what each answered (it needs a card). A worker is
this module run with `--worker <mode>`.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np

# the JAX package's dry run on 8 devices, mesh 2x4 (MULTICHIP_r05.json)
JAX_DRYRUN = ("JAX dry run, 8 devices, mesh 2x4: fast 3.49e-13, accurate "
              "1.66e-13, complex 5.53e-14")
_TIMEOUT = 300


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode: str, nproc: int, extra=()) -> list:
    """Run nproc workers of `mode` through the GEMMUL8_* variables on a
    free port; return their exit codes (each killed after _TIMEOUT s)."""
    return launch_world(["-m", "gemmul8_tpu_torch.parallel.smoke",
                         "--worker", mode, *map(str, extra)], nproc)


def launch_world(args, nproc: int, timeout: float = _TIMEOUT) -> list:
    """Run `python <args>` as the nproc ranks of one world through the
    GEMMUL8_* variables on a free local port; return their exit codes
    (each killed after `timeout` s)."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, GEMMUL8_COORD=f"127.0.0.1:{port}",
                   GEMMUL8_NPROC=str(nproc), GEMMUL8_PROC_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, *args], env=env))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes


def _first_line(e: BaseException) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"


def gloo_cuda_worker() -> None:
    """Ask gloo for all_gather_into_tensor, all_reduce (max and sum) and
    all_to_all_single on CUDA tensors of cuda:0; rank 0 prints what each
    answered, as JSON, with the values checked."""
    import datetime

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("--gloo-cuda needs a card")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['GEMMUL8_COORD']}",
        world_size=int(os.environ["GEMMUL8_NPROC"]),
        rank=int(os.environ["GEMMUL8_PROC_ID"]),
        timeout=datetime.timedelta(seconds=60))
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)

    def gather():
        out = torch.empty(world * 4, dtype=torch.int64, device=dev)
        dist.all_gather_into_tensor(
            out, torch.full((4,), rank, dtype=torch.int64, device=dev))
        return torch.equal(out.cpu(), torch.arange(world).repeat_interleave(4))

    def reduce_max():
        t = torch.full((5,), rank, dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool((t.cpu() == world - 1).all())

    def reduce_sum():
        t = torch.full((5,), rank + 1, dtype=torch.int32, device=dev)
        dist.all_reduce(t)
        return bool((t.cpu() == world * (world + 1) // 2).all())

    def to_all():
        # block j of rank r holds 16 j + r; rank r receives 16 r + i from i
        ids = torch.arange(world, dtype=torch.uint8)
        inp = (ids * 16 + rank).repeat_interleave(3)
        out = torch.empty_like(inp, device=dev)
        dist.all_to_all_single(out, inp.to(dev))
        return torch.equal(out.cpu(), (ids + rank * 16).repeat_interleave(3))

    answers = {}
    for name, fn in (("all_gather_into_tensor", gather),
                     ("all_reduce_max_int32", reduce_max),
                     ("all_reduce_sum_int32", reduce_sum),
                     ("all_to_all_single_uint8", to_all)):
        try:
            torch.cuda.synchronize()
            answers[name] = "ok" if fn() else "wrong values"
            torch.cuda.synchronize()
        except Exception as e:    # the answer is the finding: record it
            answers[name] = _first_line(e)
    if rank == 0:
        print(json.dumps({"gloo_on_cuda": answers, "world": world,
                          "torch": torch.__version__,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    dist.destroy_process_group()


def smoke_worker() -> None:
    """One rank of the 2-process smoke: the GEMMUL8_* entry on gloo, a 1x2
    mesh, gemm_sharded on the rank's shards of a 32^3 f64 product, its tile
    checked against numpy (relerr < 1e-8)."""
    import torch.distributed as dist

    from . import distributed as sd
    from . import multihost

    assert multihost.initialize_from_env(force_cpu=True), \
        "initialize_from_env did not start a process group"
    assert dist.get_world_size() == 2, dist.get_world_size()
    print(multihost.process_summary(), flush=True)
    mesh = sd.make_mesh()
    m = k = n = 32
    rng = np.random.default_rng(7)
    a = (rng.random((m, k)) - .5) * np.exp(rng.standard_normal((m, k)))
    b = (rng.random((k, n)) - .5) * np.exp(rng.standard_normal((k, n)))
    tile = sd.gemm_sharded(sd.shard_of(a, mesh, ("x", "y")),
                           sd.shard_of(b, mesh, ("y", "x")), mesh,
                           num_moduli=14).numpy()
    ref = sd.shard_of(a @ b, mesh, ("x", "y")).numpy()
    rel = np.abs(tile - ref) / np.maximum(np.abs(ref), 1e-300)
    assert rel.max() < 1e-8, f"rank {mesh.rank}: relerr {rel.max()}"
    print(f"proc {mesh.rank}: tile ({mesh.x}, {mesh.y}) of mesh "
          f"{mesh.nx}x{mesh.ny} OK, relerr {rel.max():.2e}; multihost smoke "
          "OK", flush=True)
    dist.destroy_process_group()


def dryrun_operands(nx: int, ny: int):
    """The JAX dry run's operands for an nx x ny mesh, drawn in its order
    from default_rng(1): (a, b, za, zb) with m, k, n = 8 nx, 64 ny,
    8 lcm(nx, ny)."""
    m, k, n = 8 * nx, 64 * ny, 8 * math.lcm(nx, ny)
    rng = np.random.default_rng(1)
    a = (rng.random((m, k)) - 0.5) * np.exp(rng.standard_normal((m, k)) * 0.5)
    b = (rng.random((k, n)) - 0.5) * np.exp(rng.standard_normal((k, n)) * 0.5)
    za = a + 1j * (rng.random((m, k)) - 0.5)
    zb = b + 1j * (rng.random((k, n)) - 0.5)
    return a, b, za, zb


def _relerr(got, ref):
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)


def dryrun_worker() -> None:
    """One rank of the dry run: every case on the mesh of all ranks, the
    tiles gathered, rank 0 holding the global results to the JAX dry run's
    bounds and printing its line."""
    import torch
    import torch.distributed as dist

    from ..types import ComputeType
    from . import distributed as sd
    from . import multihost

    multihost.initialize_from_env(force_cpu=True)
    mesh = sd.make_mesh()
    a, b, za, zb = dryrun_operands(mesh.nx, mesh.ny)

    def sh(x, spec):
        return sd.shard_of(torch.as_tensor(x), mesh, spec)

    A, B = sh(a, ("x", "y")), sh(b, ("y", "x"))
    ZA, ZB = sh(za, ("x", "y")), sh(zb, ("y", "x"))
    tiles = {
        "fast": sd.gemm_sharded(A, B, mesh, num_moduli=14),
        "accurate": sd.gemm_sharded(A, B, mesh, num_moduli=14,
                                    fastmode=False),
        "panel": sd.gemm_sharded(A, B, mesh, num_moduli=14, n_panel=8),
        "f32": sd.gemm_sharded(A.float(), B.float(), mesh, num_moduli=8),
        "md": sd.gemm_sharded(A, B.float(), mesh, num_moduli=14,
                              out_dtype="f64"),
        "mixed": sd.gemm_sharded_complex(ZA, ZB.to(torch.complex64), mesh,
                                         num_moduli=10)}
    for name, ct in (("big", ComputeType.COMPLEX_BIG_MATRIX_ENCODE),
                     ("classic", ComputeType.COMPLEX_CLASSIC_MULT),
                     ("kara", ComputeType.COMPLEX_KARATSUBA_MULT)):
        tiles[name] = sd.gemm_sharded_complex(ZA, ZB, mesh, num_moduli=14,
                                              compute_type=ct)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, {k: v.numpy() for k, v in tiles.items()})
    dist.destroy_process_group()
    if mesh.rank:
        return
    got = {k: sd.assemble([g[k] for g in gathered], mesh).numpy()
           for k in tiles}
    ref = a @ b
    rel = {k: _relerr(got[k], ref) for k in ("fast", "accurate", "f32",
                                             "md")}
    zref = za @ zb
    for k in ("big", "classic", "kara"):
        rel[k] = _relerr(got[k], zref)
    rel["mixed"] = _relerr(got["mixed"], za @ zb.astype(np.complex64).astype(
        np.complex128))
    bounds = [("fast", rel["fast"].max() < 1e-8),
              ("accurate", rel["accurate"].max() < 1e-8),
              ("panel", np.array_equal(got["panel"], got["fast"])),
              ("f32", np.median(rel["f32"]) < 1e-6),
              ("md", np.median(rel["md"]) < 1e-6),
              ("mixed", np.median(rel["mixed"]) < 1e-6)]
    bounds += [(k, rel[k].max() < 1e-8) for k in ("big", "classic", "kara")]
    failed = [k for k, ok in bounds if not ok]
    if failed:
        raise SystemExit(f"dry run over its bounds: {failed}")
    print(f"dryrun_multichip OK on {mesh.nx * mesh.ny} ranks (mesh "
          f"{mesh.nx}x{mesh.ny}, fast relerr {rel['fast'].max():.2e}, "
          f"accurate {rel['accurate'].max():.2e}, complex big/classic/kara "
          f"{rel['big'].max():.2e}/{rel['classic'].max():.2e}/"
          f"{rel['kara'].max():.2e}, mixed-width med "
          f"{np.median(rel['mixed']):.2e}, md med {np.median(rel['md']):.2e}"
          f", f32 med {np.median(rel['f32']):.2e}) | beside it: "
          f"{JAX_DRYRUN}", flush=True)


def case_operands(case: dict):
    """The global numpy operands of a case: {"m", "k", "n", "phi",
    "seeds", "a", "b"} with "a"/"b" one of "f64", "f32", "c128", "c64";
    real parts phi_matrix(.., seed), a complex operand's Im part from the
    next seed (seeds: A's first, then B's)."""
    from ..bench.matrices import phi_matrix

    m, k, n, phi = case["m"], case["k"], case["n"], case["phi"]
    seeds = iter(case["seeds"])
    out = []
    for kind, shape in ((case["a"], (m, k)), (case["b"], (k, n))):
        x = phi_matrix(*shape, phi, seed=next(seeds))
        if kind in ("c128", "c64"):
            x = x + 1j * phi_matrix(*shape, phi, seed=next(seeds))
        out.append(x.astype({"f64": np.float64, "f32": np.float32,
                             "c128": np.complex128,
                             "c64": np.complex64}[kind]))
    return out


def run_case(case: dict, mesh):
    """This rank's tile of one case (`case_operands`, then gemm_sharded
    or, with "compute_type", gemm_sharded_complex; keywords "L",
    "fastmode", "n_panel", "out_dtype")."""
    import torch

    from ..types import ComputeType
    from . import distributed as sd

    a, b = case_operands(case)
    A = sd.shard_of(torch.from_numpy(a), mesh, ("x", "y"))
    B = sd.shard_of(torch.from_numpy(b), mesh, ("y", "x"))
    if case.get("compute_type"):
        return sd.gemm_sharded_complex(
            A, B, mesh, num_moduli=case["L"],
            compute_type=ComputeType[case["compute_type"]])
    return sd.gemm_sharded(A, B, mesh, num_moduli=case["L"],
                           out_dtype=case.get("out_dtype"),
                           fastmode=case.get("fastmode", True),
                           n_panel=case.get("n_panel"))


def case_worker(rank: int, world: int, init_method: str, cases: list,
                outdir: str) -> None:
    """One gloo rank running every case in order (for
    torch.multiprocessing): the meshes of the cases' "mesh" shapes, made
    in order of first use, and each tile saved as <outdir>/<name>.<rank>
    .npy. Also saves make_mesh()'s default shape as mesh.<rank>.npy."""
    import torch
    import torch.distributed as dist

    from . import distributed as sd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    meshes = {}
    default = sd.make_mesh()
    np.save(os.path.join(outdir, f"mesh.{rank}.npy"),
            np.array([default.nx, default.ny, default.x, default.y]))
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = sd.make_mesh(shape=shape)
        tile = run_case(case, meshes[shape])
        np.save(os.path.join(outdir, f"{case['name']}.{rank}.npy"),
                tile.numpy())
    dist.destroy_process_group()


_WORKERS = {"smoke": smoke_worker, "dryrun": dryrun_worker,
            "gloo-cuda": gloo_cuda_worker}


def main(argv) -> None:
    if "--worker" in argv:
        mode = argv[argv.index("--worker") + 1]
        if mode not in _WORKERS:
            raise SystemExit(f"unknown worker mode {mode!r}")
        _WORKERS[mode]()
        return
    if "--dryrun" in argv:
        mode, n = "dryrun", int(argv[argv.index("--dryrun") + 1])
    elif "--gloo-cuda" in argv:
        mode, n = "gloo-cuda", int(argv[argv.index("--gloo-cuda") + 1])
    elif not argv:
        mode, n = "smoke", 2
    else:
        raise SystemExit("usage: python -m gemmul8_tpu_torch.parallel.smoke "
                         "[--dryrun N | --gloo-cuda N]")
    codes = launch(mode, n)
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")
    if mode == "smoke":
        print(f"multihost smoke OK ({n} processes, gloo, mesh 1x2)")


if __name__ == "__main__":
    main(sys.argv[1:])
