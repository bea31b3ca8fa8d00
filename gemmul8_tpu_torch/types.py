"""Public types and bit converters.

Operands are native `torch.float64` and `torch.complex128` tensors: the
H100 has real f64, so the (hi, lo) uint32 word pairs the JAX package
carries (`F64Bits`, and `C64Bits` for complex) exist here only as
converters, to hand both packages the same bits in the tests.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class ComputeType(enum.Enum):
    """Complex-multiplication strategy (real inputs ignore this)."""

    REAL_DEFAULT = 0
    COMPLEX_BIG_MATRIX_ENCODE = 1
    COMPLEX_CLASSIC_MULT = 2
    COMPLEX_KARATSUBA_MULT = 3


def f64_to_words(x) -> tuple[np.ndarray, np.ndarray]:
    """float64 tensor or array -> numpy uint32 (hi, lo) words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    u = np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def words_to_f64(hi, lo, device=None) -> torch.Tensor:
    """numpy uint32 (hi, lo) words -> float64 tensor on `device`."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    u = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return torch.from_numpy(u.view(np.float64).copy()).to(device)


def c128_to_words(x):
    """complex128 tensor or array -> ((re hi, re lo), (im hi, im lo)) numpy
    uint32 words, as the JAX package's C64Bits(F64Bits, F64Bits) holds
    them."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.complex128)
    return f64_to_words(x.real), f64_to_words(x.imag)


def words_to_c128(re_words, im_words, device=None) -> torch.Tensor:
    """((re hi, re lo), (im hi, im lo)) numpy uint32 words -> complex128
    tensor on `device`, every bit of both parts kept."""
    return torch.complex(words_to_f64(*re_words),
                         words_to_f64(*im_words)).to(device)
