"""Hopper counterparts of the JAX package's four TPU probes (`scripts/`):

    clz      probe_clz.py      count-leading-zeros, and the f32-exponent
                               msb trick it replaced
    vpu_ops  probe_vpu_ops.py  nine dependent integer / f32 op chains
    mxu_crt  probe_mxu_crt.py  the CRT contraction on the tensor cores
    deaddep  probe_deaddep.py  integer work inside the residue GEMM's block

Each module holds the probe's plain PyTorch version (what the CPU tests and
chip_smoke.py hold the kernel to) and `run`, which times the
kernel on the card; the kernels' wrappers are in `hopper/probes.py`, the
sources in `csrc/probe_*.cu`. Entry point:

    python -m gemmul8_tpu_torch.probes {clz | vpu_ops |
        mxu_crt [lower | variant bm bn L m n] | deaddep [n L nops ...]}
"""
