"""Double-double reference GEMM in plain numpy.

Counterpart of `gemmul8_tpu/bench/evalref.py`, the same operations in the
same order, so both give the same bits: Dekker splitting for exact
products (numpy has no fma) and 2Sum accumulation, looped over k. About
1e-32 effective precision, far beyond every emulation target. The harness
uses the OpenMP oracle of `native.py`; this one needs no compiler.
"""

from __future__ import annotations

import numpy as np

_SPLIT = np.float64(1 << 27) + 1.0


def _two_sum(a, b):
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def dd_gemm(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A @ B in double-double. Returns (hi, lo)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m, k = a.shape
    _, n = b.shape
    s = np.zeros((m, n))
    e = np.zeros((m, n))
    for t in range(k):
        p, pe = _two_prod(a[:, t:t + 1], b[t:t + 1, :])
        s, se = _two_sum(s, p)
        e = e + (se + pe)
    return _two_sum(s, e)


def dd_gemm_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return dd_gemm(a, b)[0]
