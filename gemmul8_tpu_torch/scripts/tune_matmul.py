"""Launch-entry sweep of the int8 GEMM with its mod epilogue on the card.

Counterpart of `scripts/tune_matmul.py`:

    python -m gemmul8_tpu_torch.scripts.tune_matmul [n=8192] [L=14]

with the JAX script's positional arguments, defaults and inputs: two
(L, n, n) int8 slice stacks drawn from `default_rng(0)`. It runs
`tune_kernels`' matmul section on them: matmul_mod_u8 (csrc/matmul_mod.cu,
the wgmma tile of wgmma_s8.cuh) under the launch table's entry for (9, 0)
and under every `MatmulModLaunch` of tile 256 (the only width its source
takes), stages {2, 3, 4} x raster group {1, 4, 8, 16, 32}, each built
into a library of its own, held word for word to the table library's
output, timed in rotated rounds beside the table's entry, with the rows,
clock and exit code of `tune_kernels`.
"""

from __future__ import annotations

import sys

from . import tune_kernels as tk


def main(argv=None) -> int:
    from ..bench.power import card_line
    from ..bench.timing import require_gpu

    n, L, _ = tk.parse(list(sys.argv[1:] if argv is None else argv)[:2])
    require_gpu()
    print(f"card (name, power limit): {card_line()}", flush=True)
    rows = tk.run_section("matmul", tk.Inputs(n, L, with_a=False),
                          out=lambda s: print(s, flush=True))
    return 1 if tk.failed(rows) else 0


if __name__ == "__main__":
    sys.exit(main())
