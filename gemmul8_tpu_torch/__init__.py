"""gemmul8_tpu_torch — Ozaki Scheme II GEMM emulation on PyTorch and CUDA.

The port of `gemmul8_tpu` to an NVIDIA H100: f64, f32 and mixed real GEMM
and complex128, complex64 and mixed complex GEMM (each operand at its own
word; f64/f32 or complex128/complex64 output, op N/T/C, alpha/beta)
emulated as `num_moduli` exact int8 residue matmuls recombined by CRT,
with the statistics, encode, int8 matmul + mod (real and complex) and
reconstruct steps as hand-written Hopper kernels (`csrc/`); batched
(`gemm_batched`) and phase-timed (`gemm_timed`) calls beside `gemm`. CPU
tensors run the plain PyTorch versions of those kernels. Importing the
package needs neither JAX, nvcc nor a GPU; the kernels build at their
first launch.
"""

from . import tables
from .api import gemm, gemm_batched, gemm_timed, workspace_bytes
from .types import (ComputeType, c128_to_words, f64_to_words, words_to_c128,
                    words_to_f64)

__version__ = "0.1.0"

__all__ = ["gemm", "gemm_batched", "gemm_timed", "workspace_bytes",
           "tables", "ComputeType", "f64_to_words", "words_to_f64",
           "c128_to_words", "words_to_c128"]
