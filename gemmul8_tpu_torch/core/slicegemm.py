"""Per-modulus int8 slice products and their modular reduction.

Counterpart of `gemmul8_tpu/core/slicegemm.py`, and of the complex residue
products of `gemmul8_tpu/core/complexgemm.py`. The plain product runs as a
float64 matrix product of the int8 slices: every partial sum is an integer
of magnitude at most 128 * 128 * 2^17 = 2^31 < 2^53, so it is exact on any
device and at any shape.
"""

from __future__ import annotations

import torch

from .. import tables
from . import reconstruct as rec
from .encode import check_moduli_idx
from .modmath import mod_reduce


def slice_products(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(L, m, k) int8 x (L, k, n) int8 -> (L, m, n) int64, exact."""
    return torch.stack([(a8[l].double() @ b8[l].double()).to(torch.int64)
                        for l in range(a8.shape[0])])


def matmul_mod(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int,
               centered: bool = False, moduli_idx=None) -> torch.Tensor:
    """Residues of the slice products: canonical uint8, or r - 128 as int8
    when centered. Slice l is reduced mod MODULI[moduli_idx[l]] (default:
    all num_moduli in order). One modulus at a time, to bound the f64
    temporaries."""
    idx = _check_matmul_args(a8, b8, num_moduli, moduli_idx)
    out = []
    for l, j in enumerate(idx):
        r = mod_reduce(slice_products(a8[l:l + 1], b8[l:l + 1]),
                       num_moduli, (j,))[0]
        out.append((r - 128).to(torch.int8) if centered
                   else r.to(torch.uint8))
    return torch.stack(out)


def matmul_crt(a8: torch.Tensor, b8: torch.Tensor,
               num_moduli: int) -> torch.Tensor:
    """(L, m, k) x (L, k, n) int8 -> (num_limbs, m, n) int32 canonical
    16-bit limbs of X = sum_l w_l * ((a8[l] @ b8[l]) mod m_l): the slice
    products, their residues and `accumulate_weighted`, one modulus at a
    time. The function of the JAX package's `matmul_crt_pallas`."""
    _check_matmul_args(a8, b8, num_moduli)
    acc = None
    for l in range(num_moduli):
        r = mod_reduce(slice_products(a8[l:l + 1], b8[l:l + 1]),
                       num_moduli, (l,))
        acc = rec.accumulate_weighted(r, num_moduli, (l,), acc)
    return torch.stack(acc).to(torch.int32)


def matmul_reconstruct(a8: torch.Tensor, b8: torch.Tensor,
                       sft_a: torch.Tensor, sft_b: torch.Tensor,
                       num_moduli: int, out_dtype: str = "f64"):
    """`matmul_mod` then `reconstruct`: the function of the JAX package's
    `matmul_reconstruct_pallas`."""
    return rec.reconstruct(matmul_mod(a8, b8, num_moduli), sft_a, sft_b,
                           num_moduli, out_dtype)


def recenter_add_int8(x8: torch.Tensor, y8: torch.Tensor,
                      num_moduli: int) -> torch.Tensor:
    """(L, ...) int8 residues x + y mod m_j, centered: for odd m_j in
    [-(m_j - 1)/2, (m_j - 1)/2], for 256 in [-128, 127] (the sum's low
    byte). The Karatsuba sum slices; the counterpart of the JAX package's
    `_recenter_add_int8`, for any int8 inputs. Plain tensor ops on x8's
    device, in int16: ((x + y + h) mod m) - h with h = (m - 1) / 2, or 128
    for 256."""
    if x8.dtype != torch.int8 or y8.dtype != torch.int8:
        raise TypeError("slices must be int8")
    if x8.shape != y8.shape or x8.shape[0] != num_moduli:
        raise ValueError(f"expected two ({num_moduli}, ...) slices of one "
                         "shape")
    mods = tables.MODULI[:num_moduli]
    shape = (num_moduli,) + (1,) * (x8.dim() - 1)
    m = torch.tensor(mods, dtype=torch.int16, device=x8.device).view(shape)
    h = torch.tensor([128 if mj == 256 else (mj - 1) // 2 for mj in mods],
                     dtype=torch.int16, device=x8.device).view(shape)
    t = x8.to(torch.int16) + y8
    return (torch.remainder(t + h, m) - h).to(torch.int8)


def matmul_complex_mod(a8r, a8i, b8r, b8i, num_moduli: int,
                       centered: bool = False, kara=None):
    """Re and Im residues of the complex slice products
    (a8r + i a8i)(b8r + i b8i), (L, m, k) x (L, k, n) int8 each:
    (RR - II, IR + RI) mod m_l, or with kara = (s_a, s_b), the Karatsuba
    sum slices, (E - F, G - E - F) for E = RR, F = II, G = s_a s_b. Both
    forms give the same residues. Canonical uint8, or r - 128 as int8 when
    centered; one modulus at a time, to bound the f64 temporaries."""
    check_complex_args(a8r, a8i, b8r, b8i, num_moduli, kara)
    outs = ([], [])
    for l in range(a8r.shape[0]):
        def prod(x, y):
            return (x[l].double() @ y[l].double()).to(torch.int64)
        if kara is None:
            re = prod(a8r, b8r) - prod(a8i, b8i)
            im = prod(a8i, b8r) + prod(a8r, b8i)
        else:
            e, f = prod(a8r, b8r), prod(a8i, b8i)
            re, im = e - f, prod(*kara) - e - f
        for v, out in zip((re, im), outs):
            r = mod_reduce(v[None], num_moduli, (l,))[0]
            out.append((r - 128).to(torch.int8) if centered
                       else r.to(torch.uint8))
    return torch.stack(outs[0]), torch.stack(outs[1])


def check_complex_args(a8r, a8i, b8r, b8i, num_moduli: int, kara=None):
    """The complex product's slices: A's parts (L, m, k), B's (L, k, n),
    and with kara the sums s_a (L, m, k) and s_b (L, k, n); k <= 2^16."""
    _check_matmul_args(a8r, b8r, num_moduli)
    a_parts = (a8r, a8i) if kara is None else (a8r, a8i, kara[0])
    b_parts = (b8r, b8i) if kara is None else (b8r, b8i, kara[1])
    for x in a_parts + b_parts:
        if x.dtype != torch.int8:
            raise TypeError("slices must be int8")
    if any(x.shape != a8r.shape for x in a_parts) or any(
            x.shape != b8r.shape for x in b_parts):
        raise ValueError("the parts of each operand must have one shape")
    if a8r.shape[2] > tables.MAX_K // 2:
        raise ValueError(f"k={a8r.shape[2]} exceeds the complex bound 2^16")


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


def _check_matmul_args(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int,
                       moduli_idx=None) -> tuple:
    """Raise on slices the residue GEMMs do not take; returns the moduli
    index of each slice (`check_moduli_idx`)."""
    idx = check_moduli_idx(moduli_idx, num_moduli)
    if a8.dtype != torch.int8 or b8.dtype != torch.int8:
        raise TypeError("slices must be int8")
    if a8.dim() != 3 or b8.dim() != 3:
        raise ValueError("slices must be (L, m, k) and (L, k, n)")
    if a8.shape[0] != len(idx) or b8.shape[0] != len(idx):
        raise ValueError(f"expected {len(idx)} slices per operand")
    if a8.shape[2] != b8.shape[1]:
        raise ValueError(f"inner dims mismatch: {tuple(a8.shape)} x "
                         f"{tuple(b8.shape)}")
    if a8.shape[2] > tables.MAX_K:
        raise ValueError(f"k={a8.shape[2]} exceeds the int32-exactness "
                         "bound 2^17")
    return idx


def int8_probe_step(n: int, seed: int = 0, device="cuda"):
    """The INT8-GEMM probe's step and first state: two random int8 (n, n)
    operands drawn from an explicit torch.Generator, and step((a, b)) ->
    (a ^ int8(a @ b), b), one `torch._int_mm` a step, each step's left
    operand depending on the product before it. B is column-major (the
    transpose of a contiguous draw), the layout cuBLASLt's int8
    tensor-core GEMM takes: with a row-major B the probe ran at 128 TOPS
    on the H100 (NVIDIA H100 80GB HBM3, 700 W)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=device,
                      generator=gen)
    b = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=device,
                      generator=gen).t()

    def step(st):
        x, y = st
        x ^= torch._int_mm(x, y).to(torch.int8)
        return x, y

    return step, (a, b)


def int8_peak_probe(n: int = 4096, iters: int = 10) -> float:
    """Raw int8 tensor-core throughput (TOPS, 2 n^3 / t): the analog of the
    reference's INT8-GEMM row, on the card only (`require_gpu`). Chained
    `torch._int_mm` steps (`int8_probe_step`; the fold into the left
    operand is one elementwise pass a step, as in the JAX package), timed
    by `bench.timing.chained_time` (CUDA events, nothing subtracted).
    `iters` is a minimum: it is raised to at least 30, and so that the
    timed steps take about 0.1 s at 1000 TOPS (at most 2000 steps)."""
    from ..bench.timing import chained_time, require_gpu

    require_gpu()
    step, state = int8_probe_step(n)
    est_step_s = 2 * n ** 3 / 1000e12
    iters = max(iters, 30, min(int(0.1 / est_step_s) + 1, 2000))
    dt, _ = chained_time(step, state, iters)
    return 2 * n ** 3 / dt / 1e12
