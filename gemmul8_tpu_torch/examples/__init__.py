"""Examples of the port, counterparts of the JAX package's `examples/`:

    python -m gemmul8_tpu_torch.examples.one_accuracy           [--n --device]
    python -m gemmul8_tpu_torch.examples.one_accuracy_complex   [--n --device]
    python -m gemmul8_tpu_torch.examples.profile_one_call
        [--n --moduli --iters --trace-dir --device]
    python -m gemmul8_tpu_torch.examples.distributed_gemm       [--device]

and the port's own blocked LU on emulated trailing updates:

    python -m gemmul8_tpu_torch.examples.blocked_lu
        [--n --nb --moduli --device]

Each runs on the card unless `--device cpu` is given (the kernels' plain
versions), and has a `main(argv=None)` that tests call.
"""
