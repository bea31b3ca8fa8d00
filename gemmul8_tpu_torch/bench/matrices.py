"""Test-matrix generation and error metrics, as
`gemmul8_tpu/bench/matrices.py` makes them.

phi-difficulty model: elements (uniform - 0.5) * exp(normal * phi), drawn
from numpy's default_rng(seed), so the port's operands are bit-identical to
the JAX package's for the same (m, n, phi, seed); phi = 0.5 is about HPL
difficulty. Metrics: max and median elementwise relative error against a
reference product; `exact_gemm_f64` is an exact big-integer ground truth
for small sizes, `latms_matrix` a matrix of a prescribed condition number.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def phi_matrix(m: int, n: int, phi: float, seed: int,
               dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.random((m, n))
    g = rng.standard_normal((m, n))
    return ((u - 0.5) * np.exp(g * phi)).astype(dtype)


def exact_gemm_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact A @ B of float64 inputs in Python rationals, rounded once to
    f64 (`float(Fraction)` rounds to nearest even). O(m n k) Python: small
    sizes only."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
    af = [[Fraction(float(x)) for x in row] for row in a]
    bf = [[Fraction(float(x)) for x in row] for row in b]
    out = np.zeros((m, n), np.float64)
    for i in range(m):
        for j in range(n):
            s = Fraction(0)
            for t in range(k):
                s += af[i][t] * bf[t][j]
            out[i, j] = float(s)
    return out


def relerr_stats(c: np.ndarray, ref: np.ndarray):
    """(max, median) elementwise relative error; a zero reference element
    divides by 1."""
    denom = np.abs(ref)
    denom = np.where(denom == 0, 1.0, denom)
    e = np.abs(c.astype(np.float64) - ref) / denom
    return float(np.max(e)), float(np.median(e))


def latms_matrix(m: int, n: int, cond: float, seed: int,
                 dtype=np.float64) -> np.ndarray:
    """Random matrix with a prescribed 2-norm condition number, as LAPACK's
    latms-style generators make one: orthogonal factors around a
    log-spaced singular spectrum from 1 down to 1/cond."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.logspace(0.0, -np.log10(cond), k)
    return ((u * s) @ v.T).astype(dtype)
