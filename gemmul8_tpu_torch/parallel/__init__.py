"""The sharded engine over torch.distributed and its multi-process entry.

Counterpart of `gemmul8_tpu/parallel`: `distributed` runs the emulated
GEMM 2-D sharded over a mesh of ranks, one card each (NCCL; gloo for CPU
tensors), and `multihost` starts the process group from the `GEMMUL8_*`
variables or a launcher's world. `smoke` drives both on CPU ranks.
Importing the package starts no process group.
"""
