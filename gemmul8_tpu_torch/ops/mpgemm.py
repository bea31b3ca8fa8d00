"""Mutable-precision SGEMM on bf16 tensor cores (cuMpSGEMM analog).

Counterpart of `gemmul8_tpu/ops/mpgemm.py`. The reference suite includes
cuMpSGEMM: SGEMM/CGEMM on FP16/TF32 tensor cores with Ootomo-style error
correction (TCEC), exponent-statistics-driven precision selection and
dynamic scaling. Here each f32 operand is split into leading and residual
bf16 parts and the cross products are summed ("bf16x3": hi*hi + hi*lo +
lo*hi, the TCEC recipe with bf16; "bf16x6" adds the second-order terms).

Modes (cuMpSGEMM's compute modes):
  NATIVE  - f32 matmul, TF32 off
  BF16TC  - one bf16 product (TF32TC analog)
  BF16X3  - error-corrected 3-product split (FP16TCEC analog)
  BF16X6  - 6-term split (full f32 accuracy)
  SCALING - per-row/col power-of-2 scaling + BF16X3 (FP16TCEC_SCALING)
  AUTO    - exp_stats-driven choice between BF16X3 and NATIVE

Every bf16 product has an f32 accumulator and an f32 result: on the card
`torch.mm` / `torch.bmm` with `out_dtype=torch.float32` (a bf16 result
would round every product sum to 8 bits, BF16TC's accuracy); on the CPU
the bf16 parts are widened to f32 (exactly) and multiplied in f32. The
f32 products (NATIVE, AUTO's full-precision branch) run with TF32 off,
restored after the call. Every entry point runs on the card unless
`device="cpu"` is given; numpy operands go to `device`.
"""

from __future__ import annotations

import contextlib
import enum
from typing import NamedTuple

import numpy as np
import torch

from ..api import _as_tensor


class Mode(enum.Enum):
    NATIVE = "native"
    BF16TC = "bf16tc"
    BF16X3 = "bf16x3"
    BF16X6 = "bf16x6"
    SCALING = "scaling"
    AUTO = "auto"


class ExpStats(NamedTuple):
    """Exponent statistics of a tensor: the biased f32 exponent of its
    largest element, and the fraction of nonzero elements more than
    `lose_threshold` octaves below it (those lose residual-split
    precision)."""

    max_exp: torch.Tensor        # int32 biased exponent of amax
    lost_fraction: torch.Tensor  # f32 in [0, 1]
    total: torch.Tensor          # nonzero count (at least 1)


def _f32(x, device) -> torch.Tensor:
    return _as_tensor(x, device, "operand").to(torch.float32)


def exp_stats(x, lose_threshold: int = 16, device="cuda") -> ExpStats:
    x = _f32(x, device)
    e = (x.contiguous().view(torch.int32) >> 23) & 0xFF
    nz = e > 0
    emax = torch.where(nz, e, 0).max()
    lost = (nz & (e < emax - lose_threshold)).sum().to(torch.int32)
    total = torch.clamp(nz.sum().to(torch.int32), min=1)
    return ExpStats(emax, lost.to(torch.float32) / total.to(torch.float32),
                    total)


def _split_bf16(x: torch.Tensor):
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (..., m, k) x (..., k, n) -> f32, an f32 accumulator and an f32
    result (never a bf16-rounded sum)."""
    if a.is_cuda:
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        batch = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        return out.reshape(*batch, *out.shape[-2:])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


@contextlib.contextmanager
def no_tf32():
    """f32 products in full f32 inside the block (TF32 off); the caller's
    setting is restored after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _native(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with no_tf32():
        return torch.matmul(a, b)


def _bf16x3(a, b):
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return _dot(ah, bh) + (_dot(ah, bl) + _dot(al, bh))


def _bf16x6(a, b):
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    a2 = (a - ah.to(torch.float32) - al.to(torch.float32)).to(torch.bfloat16)
    b2 = (b - bh.to(torch.float32) - bl.to(torch.float32)).to(torch.bfloat16)
    return (_dot(ah, bh)
            + (_dot(ah, bl) + _dot(al, bh))
            + (_dot(al, bl) + _dot(ah, b2) + _dot(a2, bh)))


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) of positive finite f32 values, exactly: frexp's
    exponent less 1 (v = m 2^e, m in [0.5, 1)). XLA's CPU log2 is not
    correctly rounded (ROADMAP C3), so the JAX package's value may be one
    lower just under a power of two; the scaled product is the same but
    at the f32 range's ends."""
    return (torch.frexp(v).exponent - 1).to(torch.int64)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e as f32 for integer e in [-1022, 1023] whose power is an
    f32 value (normal or subnormal): built in f64 from its bits."""
    return ((e + 1023) << 52).view(torch.float64).to(torch.float32)


def _scaled_bf16x3(a, b):
    """Dynamic scaling: scale rows of a / columns of b to near-1 magnitude
    by powers of two (exact), multiply, unscale. Protects the residual
    split from underflow at extreme magnitudes. The clamp is the smallest
    normal f32, so an all-zero line keeps scale 2^126, not inf."""
    tiny = torch.finfo(torch.float32).tiny
    ea = _floor_log2(torch.clamp(a.abs().amax(dim=-1, keepdim=True),
                                 min=tiny))
    eb = _floor_log2(torch.clamp(b.abs().amax(dim=-2, keepdim=True),
                                 min=tiny))
    c = _bf16x3(a * _pow2(-ea), b * _pow2(-eb))
    # unscale with two factors: 2^(ea + eb) overflows f32 when ea + eb >
    # 127 even though each factor (and the product) is finite
    return c * _pow2(ea) * _pow2(eb)


_CUSTOM_MX2X2 = True


def enable_custom_gemm_Mx2x2() -> None:
    """Route (m, 2) x (2, 2) GEMMs through the elementwise path (default;
    the cuGEMM-Mx2x2 analog: a k = 2, n = 2 product wastes a tensor-core
    tile)."""
    global _CUSTOM_MX2X2
    _CUSTOM_MX2X2 = True


def disable_custom_gemm_Mx2x2() -> None:
    global _CUSTOM_MX2X2
    _CUSTOM_MX2X2 = False


def gemm_Mx2x2(a, b, device="cuda"):
    """GEMM-(2^p, 2, 2): a (..., m, 2) x b (..., 2, 2) as broadcast
    multiplies and adds, one torch op a step (each rounded once, never an
    FMA: numpy's separate operations, bit for bit); real or complex, plain
    or batched through leading dims."""
    a = _as_tensor(a, device, "a")
    b = _as_tensor(b, device, "b")
    if a.shape[-1] != 2 or tuple(b.shape[-2:]) != (2, 2):
        raise ValueError(f"expected (..., m, 2) x (..., 2, 2), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    a0, a1 = a[..., 0:1], a[..., 1:2]

    def bcol(i, j):  # (..., 1, 1): broadcasts against a's (..., m, 1)
        return b[..., i:i + 1, j:j + 1]

    return torch.cat([a0 * bcol(0, 0) + a1 * bcol(1, 0),
                      a0 * bcol(0, 1) + a1 * bcol(1, 1)], dim=-1)


def mp_gemm(a, b, mode: Mode = Mode.AUTO, auto_lost_threshold: float = 0.05,
            device="cuda") -> torch.Tensor:
    """Mutable-precision f32 GEMM, a (..., m, k) x b (..., k, n) -> float32
    tensor on `device`.

    AUTO reads both operands' `lost_fraction` on the host (one sync) and
    runs only the branch it picks: the f32 product (TF32 off) where either
    exceeds auto_lost_threshold, else BF16X3. (The JAX package picks on the
    device with `lax.cond`.)"""
    a = _f32(a, device)
    b = _f32(b, device)
    if _CUSTOM_MX2X2 and a.shape[-1] == 2 and tuple(b.shape[-2:]) == (2, 2):
        # f32 mult-adds round once each: at least the accuracy of every
        # mode (incl. SCALING's 2^s round trip), never worse
        return gemm_Mx2x2(a, b, device=a.device)
    if mode == Mode.NATIVE:
        return _native(a, b)
    if mode == Mode.BF16TC:
        return _dot(a.to(torch.bfloat16), b.to(torch.bfloat16))
    if mode == Mode.BF16X3:
        return _bf16x3(a, b)
    if mode == Mode.BF16X6:
        return _bf16x6(a, b)
    if mode == Mode.SCALING:
        return _scaled_bf16x3(a, b)
    if mode == Mode.AUTO:
        bad = torch.maximum(exp_stats(a, device=a.device).lost_fraction,
                            exp_stats(b, device=b.device).lost_fraction)
        if float(bad) > float(np.float32(auto_lost_threshold)):
            return _native(a, b)
        return _bf16x3(a, b)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Imperative exp_stats / dynamic-scaling surface (cuMpSGEMM's exp_stats_ext /
# exp_max_ext buffer ids, get_exp_stats, thresholds, enable/disable,
# compute-mode level, scale_A/B/C). As in the JAX package, the scale_* calls
# return the scaled tensor instead of changing it in place; buffer ids and
# stats behave as the CUDA API's.
# ---------------------------------------------------------------------------


class ExpStatsHandle:
    """Stats-buffer ring mirroring the cuMpSGEMM handle's exp_stats state.
    Operands are read on `device` (numpy ones moved there)."""

    def __init__(self, ring_size: int = 256, device="cuda"):
        self.enabled = False
        self.ignore_threshold = 0.0
        self.underflow_threshold = 2.0 ** -15
        self.underflow_ratio_tolerance = 0.05
        self.device = device
        self._ring_size = ring_size
        self._buffers: dict[int, tuple] = {}
        self._next_id = 1
        self._current_id = 0

    def set_exp_stats_params(self, ignore_threshold: float,
                             underflow_threshold: float,
                             underflow_ratio_tolerance: float) -> None:
        self.ignore_threshold = float(ignore_threshold)
        self.underflow_threshold = float(underflow_threshold)
        self.underflow_ratio_tolerance = float(underflow_ratio_tolerance)

    def enable_exp_stats(self) -> None:
        self.enabled = True

    def disable_exp_stats(self) -> None:
        self.enabled = False

    def exp_stats_ext(self, x) -> int:
        """Count elements below the underflow threshold (ignoring those at
        or below ignore_threshold) and stash (lost, total, max|x|) in a new
        buffer; returns its id. The thresholds compare in f32."""
        ax = _f32(x, self.device).abs()
        considered = ax > float(np.float32(self.ignore_threshold))
        lost = (considered
                & (ax < float(np.float32(self.underflow_threshold)))).sum()
        total = considered.sum()
        return self._store((int(lost), int(total), float(ax.max())))

    def exp_max_ext(self, x) -> int:
        ax = _f32(x, self.device).abs()
        return self._store((0, int(ax.numel()), float(ax.max())))

    def _store(self, rec) -> int:
        bid = self._next_id
        self._next_id += 1
        self._buffers[bid] = rec
        self._current_id = bid
        if len(self._buffers) > self._ring_size:
            self._buffers.pop(min(self._buffers))
        return bid

    def get_exp_stats(self, buffer_id: int) -> tuple:
        lost, total, _ = self._buffers[buffer_id]
        return lost, total

    def get_max_exp(self, buffer_id: int) -> float:
        return self._buffers[buffer_id][2]

    def get_current_exp_stats_buffer_id(self) -> int:
        return self._current_id

    def reset_exp_stats_buffer_id(self) -> None:
        self._current_id = 0

    def get_exp_stats_compute_mode_level(self, buffer_id: int) -> Mode:
        """AUTO-mode decision from a stats buffer (the reference returns
        FP16TCEC vs FP16TCEC_SCALING by underflow ratio)."""
        lost, total, _ = self._buffers[buffer_id]
        ratio = lost / max(total, 1)
        return (Mode.SCALING if ratio > self.underflow_ratio_tolerance
                else Mode.BF16X3)

    def _scale_factor(self, buffer_id: int) -> float:
        """2^-floor(log2(max|x|)) of a buffer (1 for an all-zero one), an
        exact power of two."""
        amax = self._buffers[buffer_id][2]
        if amax <= 0.0:
            return 1.0
        return float(_pow2(-_floor_log2(torch.tensor(amax,
                                                     dtype=torch.float32))))

    def scale_A(self, buffer_id: int, a):
        return _f32(a, self.device) * self._scale_factor(buffer_id)

    def scale_B(self, buffer_id: int, b):
        return _f32(b, self.device) * self._scale_factor(buffer_id)

    def scale_C(self, buffer_a_id: int, buffer_b_id: int, c):
        inv = (1.0 / self._scale_factor(buffer_a_id)
               / self._scale_factor(buffer_b_id))
        return _f32(c, self.device) * inv

    def reset_scale_A(self, buffer_id: int, a):
        return _f32(a, self.device) / self._scale_factor(buffer_id)

    reset_scale_B = reset_scale_A


_DEFAULT_HANDLE = ExpStatsHandle()


def default_handle() -> ExpStatsHandle:
    """Module-level handle on the card (one process-wide handle unless the
    caller makes their own)."""
    return _DEFAULT_HANDLE


def mp_cgemm(a, b, mode: Mode = Mode.BF16X3, device="cuda") -> torch.Tensor:
    """complex64 mutable-precision GEMM from 4 real mp_gemms, (RR - II) +
    i(RI + IR); the parts and the result stay complex64 on `device`."""
    a = _as_tensor(a, device, "a").to(torch.complex64)
    b = _as_tensor(b, device, "b").to(torch.complex64)
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    br, bi = b.real.contiguous(), b.imag.contiguous()
    rr = mp_gemm(ar, br, mode, device=a.device)
    ii = mp_gemm(ai, bi, mode, device=a.device)
    ri = mp_gemm(ar, bi, mode, device=a.device)
    ir = mp_gemm(ai, br, mode, device=a.device)
    return torch.complex(rr - ii, ri + ir)
