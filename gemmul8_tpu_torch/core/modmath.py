"""Exact modular reduction by small constant moduli with an f32 quotient.

Counterpart of `gemmul8_tpu/core/modmath.py`. Integers are held in int64
tensors whose values stay inside the int32 range the proofs assume; every
f32 step is a separate rounding (multiply, then subtract), as in the JAX
package, and float -> int casts truncate toward zero.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables


def mod_u26(x: torch.Tensor, m: int, bound_bits: int = 26) -> torch.Tensor:
    """x mod m for 0 <= x < 2^bound_bits (<= 28), 2 <= m <= 256. Exact.

    bound_bits <= 26: the biased-down (0.25) f32 quotient lies in {q-1, q},
    so one fixup suffices. 27/28 bits: bias 1.0 and two fixups (m >= 16)."""
    rinv = float(np.float32(1.0 / m))
    if bound_bits <= 26:
        q = (x.float() * rinv - 0.25).to(x.dtype)
        r = x - q * m
        return r - torch.where(r >= m, m, 0)
    if bound_bits > 28 or m < 16:
        raise ValueError(f"mod_u26: bound_bits {bound_bits} with m {m}")
    q = torch.clamp((x.float() * rinv - 1.0).to(x.dtype), min=0)
    r = x - q * m
    for s in (2, 1):
        r = r - torch.where(r >= s * m, s * m, 0)
    return r


def mod_i32(x: torch.Tensor, m: int) -> torch.Tensor:
    """Canonical x mod m in [0, m) for any int32-range x, 2 <= m <= 256.

    The f32 quotient biased down by 8 lies in [q-15, q]: four halving
    fixups cover it."""
    rinv = float(np.float32(1.0 / m))
    q = torch.floor(x.float() * rinv - 8.0).to(x.dtype)
    r = x - q * m
    for s in (8, 4, 2, 1):
        r = r - torch.where(r >= s * m, s * m, 0)
    return r


def mod_reduce(c: torch.Tensor, num_moduli: int,
               moduli_idx=None) -> torch.Tensor:
    """Canonical residues (L, m, n) int64 in [0, m_j) of the products."""
    if moduli_idx is None:
        moduli_idx = tuple(range(num_moduli))
    out = []
    for jj, j in enumerate(moduli_idx):
        m = tables.MODULI[j]
        out.append(c[jj] & 255 if m == 256 else mod_i32(c[jj], m))
    return torch.stack(out)
