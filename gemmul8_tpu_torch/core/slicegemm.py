"""Per-modulus int8 slice products and their modular reduction.

Counterpart of `gemmul8_tpu/core/slicegemm.py`. The plain product runs as a
float64 matrix product of the int8 slices: every partial sum is an integer
of magnitude at most 128 * 128 * 2^17 = 2^31 < 2^53, so it is exact on any
device and at any shape.
"""

from __future__ import annotations

import torch

from .. import tables
from .modmath import mod_i32


def slice_products(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(L, m, k) int8 x (L, k, n) int8 -> (L, m, n) int64, exact."""
    return torch.stack([(a8[l].double() @ b8[l].double()).to(torch.int64)
                        for l in range(a8.shape[0])])


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


def matmul_mod(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int,
               centered: bool = False) -> torch.Tensor:
    """Residues of the slice products: canonical uint8, or r - 128 as int8
    when centered. One modulus at a time, to bound the f64 temporaries."""
    _check_matmul_args(a8, b8, num_moduli)
    out = []
    for l in range(a8.shape[0]):
        r = mod_reduce(slice_products(a8[l:l + 1], b8[l:l + 1]),
                       num_moduli, (l,))[0]
        out.append((r - 128).to(torch.int8) if centered
                   else r.to(torch.uint8))
    return torch.stack(out)


def magmax(mag_a: torch.Tensor, mag_b: torch.Tensor):
    """Row and column maxima of the magnitude product |A| x |B|:
    (m, k) x (k, n) int8 in [0, 64] -> (smax_row (m, 1), smax_col (1, n))
    int32. The f64 product is exact: every partial sum is an integer of at
    most 64 * 64 * 2^17 = 2^29 < 2^53."""
    check_magmax_args(mag_a, mag_b)
    s = mag_a.double() @ mag_b.double()
    return (s.amax(dim=1, keepdim=True).to(torch.int32),
            s.amax(dim=0, keepdim=True).to(torch.int32))


def check_magmax_args(mag_a: torch.Tensor, mag_b: torch.Tensor):
    if mag_a.dtype != torch.int8 or mag_b.dtype != torch.int8:
        raise TypeError("magnitudes must be int8")
    if mag_a.dim() != 2 or mag_b.dim() != 2:
        raise ValueError("magnitudes must be (m, k) and (k, n)")
    if mag_a.shape[1] != mag_b.shape[0] or mag_a.shape[1] == 0:
        raise ValueError(f"inner dims mismatch or empty: "
                         f"{tuple(mag_a.shape)} x {tuple(mag_b.shape)}")
    if mag_a.shape[1] > tables.MAX_K:
        raise ValueError(f"k={mag_a.shape[1]} exceeds the bound 2^17")


def _check_matmul_args(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int):
    if a8.dtype != torch.int8 or b8.dtype != torch.int8:
        raise TypeError("slices must be int8")
    if a8.dim() != 3 or b8.dim() != 3:
        raise ValueError("slices must be (L, m, k) and (L, k, n)")
    if a8.shape[0] != num_moduli or b8.shape[0] != num_moduli:
        raise ValueError(f"expected {num_moduli} slices per operand")
    if a8.shape[2] != b8.shape[1]:
        raise ValueError(f"inner dims mismatch: {tuple(a8.shape)} x "
                         f"{tuple(b8.shape)}")
    if a8.shape[2] > tables.MAX_K:
        raise ValueError(f"k={a8.shape[2]} exceeds the int32-exactness "
                         "bound 2^17")
