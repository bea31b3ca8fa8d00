"""The plain reference that decides `correct`, and its control.

Plain PyTorch on the inputs the benchmark made, nothing else: no module
of the program, no weights, scales or tables it derived. For a call C =
alpha A B + beta C0 the reference is computed in float64 from the exact
operands (a float32 or complex64 operand widens exactly), in blocks of
rows, and each output is judged by its widest gap to it, as a share of
the size of the terms that make it up:

    err = max |out - ref| / (|alpha| |A| |B| + |beta| |C0|)

elementwise, with |x| = |Re x| + |Im x| for a complex element and the
larger of the Re and Im gaps. A float64 reference has an error of about
k 2^-53 of that denominator, under the limits set for either cell.
Outputs that are not finite are counted apart.

The control puts the reference in the program's place at the next
precision below the configuration's: float32 products for a float64
deployment, and TF32 products (operands rounded to TF32's 10-bit
significand, then float32 arithmetic) for a float32 one. TF32 is rounded
by hand, so the control reads the same on the CPU as on the card.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 2048


def _parts(x: torch.Tensor):
    """(Re, Im or None) of x in float64."""
    if x.is_complex():
        return x.real.double(), x.imag.double()
    return x.double(), None


def _mm(ar, ai, br, bi):
    """(Re, Im or None) of (ar + i ai)(br + i bi) in the parts' dtype."""
    if ai is None and bi is None:
        return ar @ br, None
    ai = torch.zeros_like(ar) if ai is None else ai
    bi = torch.zeros_like(br) if bi is None else bi
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _abs(re, im):
    return re.abs() if im is None else re.abs() + im.abs()


class _NoTF32:
    """float32 matmuls in float32 on the card while inside."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def errors(a, b, alpha: float, beta: float, c, outputs,
           block_rows: int = BLOCK_ROWS):
    """(err, nonfinite): the widest gap of every output of the call to the
    reference (NaN where an output has a non-finite element) and the
    count of non-finite output elements."""
    br, bi = _parts(b)
    babs = _abs(br, bi)
    err = torch.zeros((), dtype=torch.float64, device=br.device)
    nonfinite = 0
    with _NoTF32():
        for r0 in range(0, a.shape[0], block_rows):
            r1 = min(r0 + block_rows, a.shape[0])
            ar, ai = _parts(a[r0:r1])
            rr, ri = _mm(ar, ai, br, bi)
            den = abs(alpha) * (_abs(ar, ai) @ babs)
            del ar, ai
            if beta != 0.0:
                cr, ci = _parts(c[r0:r1])
                rr = alpha * rr + beta * cr
                ri = None if ri is None else alpha * ri + beta * ci
                den = den + abs(beta) * _abs(cr, ci)
            elif alpha != 1.0:
                rr = alpha * rr
                ri = None if ri is None else alpha * ri
            den = den.clamp_min(torch.finfo(torch.float64).tiny)
            for out in outputs:
                orr, oi = _parts(out[r0:r1])
                gap = (orr - rr).abs()
                if ri is not None:
                    gap = torch.maximum(gap, (oi - ri).abs())
                finite = torch.isfinite(orr)
                if oi is not None:
                    finite &= torch.isfinite(oi)
                nonfinite += int((~finite).sum())
                err = torch.maximum(err, (gap / den).max())
    return float(err), nonfinite


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to nearest (ties to even) at TF32's 10 explicit
    significand bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -8192
    return i.view(torch.float32)


def control(a, b, alpha: float, beta: float, c, precision: str):
    """The call computed in `precision` ("float32" or "tf32") in place of
    the program: float32 operands (TF32-rounded for "tf32"), float32
    products and sums, the result in the dtype the program returns."""
    rnd = tf32 if precision == "tf32" else (lambda x: x)
    if precision not in ("float32", "tf32"):
        raise ValueError(f"no control at precision {precision!r}")

    def parts(x):
        if x.is_complex():
            return rnd(x.real.float()), rnd(x.imag.float())
        return rnd(x.float()), None

    with _NoTF32():
        rr, ri = _mm(*parts(a), *parts(b))
    if beta != 0.0:
        cr, ci = parts(c)
        rr = alpha * rr + beta * cr
        ri = None if ri is None else alpha * ri + beta * ci
    elif alpha != 1.0:
        rr = alpha * rr
        ri = None if ri is None else alpha * ri
    out_dtype = a.dtype
    if ri is None:
        return rr.to(out_dtype)
    return torch.complex(rr, ri).to(out_dtype)


def control_gemm(precision: str):
    """`control` at `precision` with the program's call signature, to run
    in its place."""
    def gemm(a, b, alpha=1.0, beta=0.0, c=None, **_):
        return control(a, b, alpha, beta, c, precision)
    return gemm
