"""Multi-process entry path: the process group the sharded engine runs on.

Counterpart of `gemmul8_tpu/parallel/multihost.py`. The sharded engine
(`parallel.distributed`) runs one rank per card; once the default process
group exists, `make_mesh` and `gemm_sharded` work unchanged on one card,
one host or many. This module starts that group, one command per rank:

    GEMMUL8_COORD=<rank0-host:port> GEMMUL8_NPROC=<N> GEMMUL8_PROC_ID=<i> \
        [GEMMUL8_LOCAL_DEVICE_IDS=<cuda index>] python your_script.py

where the script calls `initialize_from_env()` first. The coordinator
address becomes a `tcp://` rendezvous. The backend is NCCL, which moves
CUDA tensors; `force_cpu=True` takes gloo, which moves CPU tensors, for
CPU-only runs (the JAX module's `force_cpu`). GEMMUL8_LOCAL_DEVICE_IDS
names the rank's card (`torch.cuda.set_device`); without it a rank takes
LOCAL_RANK where a launcher set it, else its rank modulo the cards it sees.

A launcher's world takes the place of the TPU pod's auto-discovery: under
torchrun (WORLD_SIZE > 1 and MASTER_ADDR set) `initialize_from_env()`
with no GEMMUL8_* variable joins that world (`env://`). With neither it
is a no-op that returns False: a single-process run needs no group.
`python -m gemmul8_tpu_torch.parallel.smoke` runs this path on two gloo
CPU ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV_COORD = "GEMMUL8_COORD"
_ENV_NPROC = "GEMMUL8_NPROC"
_ENV_PROCID = "GEMMUL8_PROC_ID"
_ENV_LOCAL_IDS = "GEMMUL8_LOCAL_DEVICE_IDS"


def initialize_from_env(force_cpu: bool = False) -> bool:
    """Start the default process group from the GEMMUL8_* variables (or a
    launcher's world). Returns True if a group was (or already had been)
    started, False for a single-process run with nothing to start.

    force_cpu: gloo, for CPU tensors, in place of NCCL."""
    if dist.is_initialized():
        return True
    env = {v: os.environ.get(v) for v in (_ENV_COORD, _ENV_NPROC,
                                          _ENV_PROCID)}
    given = {k: v for k, v in env.items() if v is not None}
    if given:
        missing = sorted(set(env) - set(given))
        if missing:
            raise ValueError(f"{', '.join(missing)} not set: a GEMMUL8_* "
                             f"launch needs {_ENV_COORD}, {_ENV_NPROC} and "
                             f"{_ENV_PROCID}")
        init = f"tcp://{env[_ENV_COORD]}"
        world, rank = int(env[_ENV_NPROC]), int(env[_ENV_PROCID])
        local = None
    elif _on_pod():
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = os.environ.get("LOCAL_RANK")
    else:
        return False    # single-process run: nothing to initialize
    backend = "gloo" if force_cpu else "nccl"
    if backend == "nccl":
        _set_device(rank, local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return True


def _set_device(rank: int, local) -> None:
    """The rank's card: GEMMUL8_LOCAL_DEVICE_IDS, else LOCAL_RANK, else
    rank modulo the cards this process sees."""
    if not torch.cuda.is_available():
        raise RuntimeError("NCCL needs a CUDA device: pass force_cpu=True "
                           "for a gloo group on the CPU")
    ids = os.environ.get(_ENV_LOCAL_IDS)
    if ids:
        parts = [int(v) for v in ids.split(",")]
        if len(parts) != 1:
            raise ValueError(f"{_ENV_LOCAL_IDS}={ids!r}: a rank runs on one "
                             "card")
        idx = parts[0]
    elif local is not None:
        idx = int(local)
    else:
        idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)


def _on_pod() -> bool:
    """Whether a launcher's multi-rank world is present (torchrun and its
    kind set WORLD_SIZE and MASTER_ADDR): the GPU cluster's counterpart of
    the TPU pod's auto-discovery."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return world > 1 and bool(os.environ.get("MASTER_ADDR"))


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> str:
    if not dist.is_initialized():
        return "process 0/1: no process group"
    backend = dist.get_backend()
    dev = (f"cuda:{torch.cuda.current_device()}" if backend == "nccl"
           else "cpu")
    return (f"process {dist.get_rank()}/{dist.get_world_size()}: 1 local of "
            f"{dist.get_world_size()} global ranks ({backend}, {dev})")
