"""Ozaki Scheme I baseline (ozIMMU-EF style) for the comparison harness.

Counterpart of `gemmul8_tpu/baselines/ozimmu.py`, on native f64 tensors,
giving its bits. The reference benches GEMMul8 against RIKEN's ozIMMU_EF
(Ozaki scheme I: exponent-block splitting of FP64 into `num_split` int8
slices, slice-pair int8 GEMMs, error-free accumulation); this gives the
harness the same comparison rows (OS1-EF-s).

FP64 operands are split bitwise into 7-bit signed slices aligned at the
per-row (A) or per-column (B) max exponent; subnormals are sliced at
exponent 1, not dropped. All slice pairs with s1 + s2 < num_split run by
diagonal d = s1 + s2: the pairs of one diagonal share a bit offset, so a
group of them is one `torch._int_mm` of A's slices side by side (m, g k)
by B's flipped slices stacked (g k, n), exact in int32 while g k 2^14 <=
2^31 (g = 2^17 // k). Each group's int32 product is added, shifted to its
offset, into signed int64 16-bit limbs; the sum is carried into two's
complement limbs (`core/limbs.py`), and its magnitude rounded once to f64
by the reconstruct's `_round_to_float`. The integer is the JAX package's,
so the bits are too. Error comes only from the slice truncation: about
2^(-7 num_split) relative to the row/column max.

`torch._int_mm` on CUDA needs more than 16 rows and k and n multiples of
8: on the card the slices are padded with zero rows and columns (exact)
and the product sliced back. Every entry point runs on the card unless
`device="cpu"` is given.
"""

from __future__ import annotations

import torch

from .. import tables
from ..api import _as_tensor
from ..core import encode as enc
from ..core import limbs as lb
from ..core.reconstruct import _assemble_f64, _round_to_float

BITS_PER_SLICE = 7  # |slice| < 2^7 -> pair products < 2^14, k <= 2^17 safe


def _split_slices(x: torch.Tensor, num_split: int, axis: int):
    """Split each element of a float64 tensor into num_split signed 7-bit
    slices aligned at the row (axis=1) or column (axis=0) max exponent.
    Returns (slices (S, *x.shape) int8, emax int64 with x's axis kept)."""
    chunks, exp, sign, normal = enc._f64_fields(x)
    emax = torch.where(normal, exp, 0).amax(dim=axis, keepdim=True)
    mant = chunks[0] | (chunks[1] << 16) | (chunks[2] << 32) | (chunks[3] << 48)
    b = BITS_PER_SLICE
    mask = (1 << b) - 1
    neg = sign == 1
    out = []
    for s in range(num_split):
        # slice s covers bits [53-(s+1)b, 53-sb) of the emax-aligned value;
        # u < 0 for deep slices of near-max elements (the window reaches
        # below the significand's last bit): a partial left placement
        u = (emax - exp) + (53 - (s + 1) * b)
        d = mant >> torch.clamp(u, 0, 63)
        ul = torch.clamp(-u, 0, b)
        v = ((d & (mask >> ul)) << ul) & mask
        v = torch.where(neg, -v, v)
        v = torch.where(normal, v, 0)
        out.append(v.to(torch.int8))
    return torch.stack(out), emax


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(S, r, c) slices with zero rows and columns appended to (S, rows,
    cols)."""
    if x.shape[1:] == (rows, cols):
        return x
    out = x.new_zeros((x.shape[0], rows, cols))
    out[:, :x.shape[1], :x.shape[2]] = x
    return out


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _slices(a: torch.Tensor, b: torch.Tensor, num_split: int, pad: bool):
    """A's row slices (S, m', k') and B's column slices as (S, n', k') (B
    transposed, so each product's right operand is column-major), with
    their max exponents (m, 1) and (1, n). pad: m' > 16 and k', n'
    multiples of 8, the zero rows and columns `torch._int_mm` on CUDA
    needs."""
    a8, emax_a = _split_slices(a, num_split, axis=1)
    b8t, emax_bt = _split_slices(b.t(), num_split, axis=1)
    if pad:
        (m, k), n = a.shape, b.shape[1]
        kp = _round8(k)
        a8 = _pad_to(a8, max(_round8(m), 24), kp)
        b8t = _pad_to(b8t, _round8(n), kp)
    return a8, emax_a, b8t, emax_bt.t()


def _diagonal_products(a8: torch.Tensor, b8t: torch.Tensor, num_split: int,
                       k: int):
    """Yield (d, int32 product) for every group of slice pairs on each
    diagonal d = s1 + s2 < num_split: A's slices s1 in [g0, g1) side by
    side times B's slices d - s1 stacked, g = 2^17 // k pairs a group."""
    g = max(1, tables.MAX_K // k)
    rows, cols, kk = a8.shape[1], b8t.shape[1], a8.shape[2]
    for d in range(num_split):
        for g0 in range(0, d + 1, g):
            g1 = min(g0 + g, d + 1)
            lhs = a8[g0:g1].permute(1, 0, 2).reshape(rows, (g1 - g0) * kk)
            rhs = torch.flip(b8t[d - g1 + 1:d - g0 + 1], (0,))
            rhs = rhs.permute(1, 0, 2).reshape(cols, (g1 - g0) * kk)
            yield d, torch._int_mm(lhs, rhs.t())


def ozimmu_gemm(a, b, num_split: int = 8, device="cuda", pad=None):
    """Emulated DGEMM via Ozaki scheme I with num_split slices: a (m, k) x b
    (k, n) float64 (tensors on `device`, or numpy arrays) -> (m, n)
    float64 tensor on `device`. Slice pairs with s1 + s2 < num_split (the
    reference's pair triangle) are evaluated by diagonal, each group of
    pairs one int8 product, the limbs of each group's product freed before
    the next. pad=None pads the slices on CUDA only; True or False forces
    it (the padded route gives the same bits)."""
    a = _as_tensor(a, device, "a")
    b = _as_tensor(b, device, "b")
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError("ozimmu_gemm takes float64 operands")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (m, k) x (k, n), got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    k = a.shape[1]
    if k > tables.MAX_K:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound "
            f"2^17 (slice-pair dot products would wrap int32)")
    if pad is None:
        pad = a.is_cuda
    bb = BITS_PER_SLICE
    m, n = a.shape[0], b.shape[1]
    a8, emax_a, b8t, emax_b = _slices(a, b, num_split, pad)
    # the exact sum, two's complement in nl 16-bit limbs: |sum| < 2^(36 +
    # 7 (num_split - 1)), under the top limb's sign bit; each limb an int64
    # partial sum of at most 136 products of |p| 2^rl < 2^46
    nl = ((num_split - 1) * bb + 32) // 16 + 2
    acc = [torch.zeros((m, n), dtype=torch.int64, device=a.device)
           for _ in range(nl)]
    for d, p in _diagonal_products(a8, b8t, num_split, k):
        wl, rl = divmod((num_split - 1 - d) * bb, 16)
        acc[wl] += p[:m, :n].to(torch.int64) << rl
        del p
    del a8, b8t
    limbs = lb.carry_propagate(acc)
    del acc
    is_negative = (limbs[-1] >> 15) == 1
    mag = lb.select(is_negative, lb.const_minus([0] * nl, limbs), limbs)
    e_fix = (emax_a - 1075) + (emax_b - 1075) + 106 - (num_split + 1) * bb
    eb, mant = _round_to_float(mag, is_negative, e_fix, 53)
    return _assemble_f64(is_negative, eb, mant)


def mantissa_loss_stats(x, num_split: int, axis: int, device="cuda"):
    """Average number of significand bits falling below the slice window
    over the nonzero elements: the statistic ozIMMU's auto mode thresholds
    on (OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD). A float32 scalar tensor:
    the bits summed exactly and divided in f32, so every device gives the
    same value (the JAX package sums them in f32, in its own order)."""
    x = _as_tensor(x, device, "x")
    _, exp, _, normal = enc._f64_fields(x)
    emax = torch.where(normal, exp, 0).amax(dim=axis, keepdim=True)
    # bits of the element below the split window [emax - num_split*b, emax)
    depth = (emax - exp) + (53 - num_split * BITS_PER_SLICE)
    lost = torch.where(normal, torch.clamp(depth, 0, 53), 0).sum()
    cnt = torch.clamp(normal.sum(), min=1)
    return lost.to(torch.float32) / cnt.to(torch.float32)


def auto_num_split(a, b, threshold: float | None = None,
                   candidates=range(3, 17), device="cuda") -> int:
    """ozIMMU `fp64_int8_auto` analog: the smallest slice count whose
    average mantissa loss (both operands) is at most `threshold` bits
    (default: GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD, `config.py`)."""
    if threshold is None:
        from .. import config as cfg
        threshold = cfg.get_config().auto_avg_mantissa_loss_threshold
    a = _as_tensor(a, device, "a")
    b = _as_tensor(b, device, "b")
    for s in candidates:
        la = float(mantissa_loss_stats(a, s, axis=1, device=device))
        lb_ = float(mantissa_loss_stats(b, s, axis=0, device=device))
        if (la + lb_) / 2 <= threshold:
            return s
    return max(candidates)


def ozimmu_gemm_np(a, b, num_split: int = 8, device="cuda"):
    """`ozimmu_gemm` of numpy float64 operands, returned as a numpy
    array."""
    return ozimmu_gemm(a, b, num_split, device=device).cpu().numpy()


def ozimmu_zgemm(a_re, a_im, b_re, b_im, num_split: int = 8,
                 device="cuda"):
    """Complex DGEMM via Ozaki-I (the reference hijacks cublasZgemm_v2 the
    same way): four real slice GEMMs combined as (RR - II) + i(RI + IR) in
    native f64, one rounding each (the JAX package's softfloat rounds to
    nearest even into the same bits). Returns (re, im) float64 tensors."""
    rr = ozimmu_gemm(a_re, b_re, num_split, device=device)
    ii = ozimmu_gemm(a_im, b_im, num_split, device=device)
    ri = ozimmu_gemm(a_re, b_im, num_split, device=device)
    ir = ozimmu_gemm(a_im, b_re, num_split, device=device)
    return rr - ii, ri + ir


def ozimmu_zgemm_np(a, b, num_split: int = 8, device="cuda"):
    """`ozimmu_zgemm` of numpy complex128 operands, returned as a numpy
    complex128 array."""
    import numpy as np

    parts = [np.ascontiguousarray(p, np.float64)
             for p in (a.real, a.imag, b.real, b.imag)]
    re, im = ozimmu_zgemm(*parts, num_split, device=device)
    return re.cpu().numpy() + 1j * im.cpu().numpy()
