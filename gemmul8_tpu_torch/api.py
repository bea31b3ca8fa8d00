"""Public front end: C = alpha * op(A) @ op(B) + beta * C emulated with
Ozaki Scheme II.

Counterpart of `gemmul8_tpu/api.py` `gemm`, `gemm_batched`, `gemm_timed`
and `workspace_bytes`. Real operands: float64 and float32 in any
combination (float16 and bfloat16 widen to float32, exactly), f64 or f32
output (`out_dtype`; by default f64 if either operand is f64), op N/T/C (C
is T on a real operand), alpha and beta, fast and accurate mode, the
one-shot schedule (and under GEMMUL8_PIPELINE its panel/rider pipeline),
the moduli-chunked low-memory one (`moduli_chunk`, or `max_workspace_bytes`
through the planner) and the column-panel one (`n_panel`), and the phase
times of the one-shot call (`return_times`, `gemm_timed`). Complex:
complex128 and complex64 operands, and real ones mixed into a complex
call, in any combination, each encoded at its own word (`core.
complexgemm`), under all three complex compute types, complex128 or
complex64 output, op N/T/C (C conjugates by the Im words' sign bits),
complex alpha and beta; the schedules and phase times are real-only, as
in the JAX package (which drops `return_times` on a complex call without a
word, ROADMAP C1; the port raises). `gemm_batched` runs a batch of real or
complex products, one element after the other.

The epilogue is separate multiplies and adds, each rounded once, as the
JAX package's: for f64 output out * alpha, c * beta, then their sum, in
native f64 (the JAX package's softfloat gives the IEEE bits); for f32
output alpha and beta are rounded to f32, c is narrowed to f32, then out *
alpha and out + beta * c in f32. The complex epilogues are those of the
JAX package's `gemm_complex` (`_complex_epilogue`). A real power-of-two
alpha with beta == 0 folds into the reconstruct's exponent instead (one
rounding of the exact product).
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from . import planner as _planner
from . import tables
from .core import complexgemm as _cg
from .core import gemm as _g
from .hopper import build as _build
from .types import ComputeType

ArrayLike = Union[torch.Tensor, np.ndarray]


def _device(device) -> Optional[torch.device]:
    """torch.device with the current CUDA index filled in ("cuda" ->
    "cuda:N"), so it compares equal to a tensor's device."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_tensor(x: ArrayLike, device, name: str) -> torch.Tensor:
    """x as a tensor on `device`: a numpy array goes there (by default to
    the current card; RuntimeError when there is none), a tensor must
    already lie there (with device None it keeps its own)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            _device(_build.card_unless(device)))
    device = _device(device)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor or numpy array")
    if device is not None and x.device != device:
        raise ValueError(f"{name} lies on {x.device}, not on {device}")
    return x


_WIDEN = (torch.float32, torch.float16, torch.bfloat16)


def _canon_real(x: ArrayLike) -> ArrayLike:
    """A real operand as float64 or float32, as the JAX package's
    `_canon_real`: float64 stays; float32, float16 and bfloat16 become
    float32 (exactly); a numpy array of any other dtype becomes float32; a
    tensor of any other dtype raises TypeError."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.float64 or np.iscomplexobj(x):
            return x
        return np.asarray(x, np.float32)
    if isinstance(x, torch.Tensor) and not x.is_complex():
        if x.dtype == torch.float64:
            return x
        if x.dtype in _WIDEN:
            return x.float()
        raise TypeError(f"unsupported operand dtype {x.dtype}")
    return x


def _is_complex_dtype(out_dtype) -> bool:
    if isinstance(out_dtype, torch.dtype):
        return out_dtype.is_complex
    return "complex" in str(out_dtype) or str(out_dtype) in ("c64", "c128")


def _out_kind(a: torch.Tensor, b: torch.Tensor, out_dtype) -> str:
    """"f64" or "f32", as the JAX package's `_out_kind` parses out_dtype
    (a torch or numpy dtype, or a string: "64" in its name is f64, "32"
    is f32, anything else a ValueError); by default f64 if either operand
    is float64. A complex out_dtype for real operands is a ValueError (the
    JAX package reads "complex64" as f64 and "complex128" as an error:
    ROADMAP C1)."""
    if out_dtype is None:
        return "f64" if torch.float64 in (a.dtype, b.dtype) else "f32"
    if _is_complex_dtype(out_dtype):
        raise ValueError(f"complex out_dtype {out_dtype} for real operands")
    s = str(out_dtype)
    if "64" in s:
        return "f64"
    if "32" in s:
        return "f32"
    raise ValueError(f"unsupported out_dtype {out_dtype}")


def _complex_out_kind(kinds, out_dtype) -> str:
    """"c128" or "c64" for a complex call: complex128 by default if either
    operand is c128 (`core.complexgemm.complex_kind`), else complex64;
    out_dtype a complex torch or numpy dtype, "complex128", "complex64",
    "c128" or "c64". A real spelling is a ValueError (the JAX package reads
    anything without "128" in it as complex64: ROADMAP C1)."""
    if out_dtype is None:
        return "c128" if "c128" in kinds else "c64"
    if isinstance(out_dtype, torch.dtype):
        if out_dtype in (torch.complex128, torch.complex64):
            return "c128" if out_dtype == torch.complex128 else "c64"
    else:
        s = str(out_dtype)
        if "complex128" in s or s == "c128":
            return "c128"
        if "complex64" in s or s == "c64":
            return "c64"
    raise ValueError(f"unsupported out_dtype {out_dtype} for a complex call")


def _apply_op(x: torch.Tensor, op: str) -> torch.Tensor:
    """BLAS-style op of a real operand: "N" itself, "T" and "C" (the
    conjugate of a real matrix is itself) its transpose."""
    if op == "N":
        return x
    if op in ("T", "C"):
        return x.t()
    raise ValueError(f"op must be N/T/C, got {op}")


def pow2_exponent(x) -> Optional[int]:
    """e if x == 2.0**e exactly (finite, positive, normal float) with
    -900 <= e <= 900, else None: the alpha `gemm` folds into the
    reconstruct's exponent, as the JAX package's `pow2_exponent`."""
    try:
        xf = float(x)
    except (TypeError, ValueError):
        return None
    if not np.isfinite(xf) or xf <= 0.0:
        return None
    m, e = np.frexp(xf)
    if m != 0.5:
        return None
    e = int(e) - 1
    return e if -900 <= e <= 900 else None


def _epilogue(out: torch.Tensor, alpha: float, beta: float,
              c: Optional[torch.Tensor]) -> torch.Tensor:
    """alpha * out + beta * c in out's dtype, as separate roundings in the
    JAX package's order: out * alpha, then beta * c, then the sum. Each
    step is its own tensor operation, so nothing contracts into an FMA
    (ROADMAP C2). For f32 output alpha and beta are rounded to f32 first
    and c is narrowed to f32; for f64 output c is widened to f64
    (exactly)."""
    dt = out.dtype
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=dt)
    if beta != 0.0:
        cb = c.to(dt) * torch.tensor(beta, dtype=dt)
        out = out + cb
    return out


def _check_c(c: torch.Tensor, m: int, n: int, device: torch.device,
             complex_ok: bool = False):
    if c.dim() != 2 or tuple(c.shape) != (m, n):
        raise ValueError(f"c has shape {tuple(c.shape)}, expected {(m, n)}")
    if c.device != device:
        raise ValueError(f"c lies on {c.device}, not on {device}")
    if c.is_complex() and complex_ok:
        _cg.complex_kind(c)
    elif c.is_complex() or not c.is_floating_point():
        raise TypeError(f"unsupported c dtype {c.dtype}")


def _cscale(re: torch.Tensor, im: torch.Tensor, z: complex):
    """(re, im) * z in f64, each product and sum its own rounding; a real
    z skips the cross terms (which would also turn -0.0 Im words into
    +0.0), as the JAX package's `_cscale`."""
    zr = torch.tensor(z.real, dtype=torch.float64)
    if z.imag == 0.0:
        return re * zr, im * zr
    zi = torch.tensor(z.imag, dtype=torch.float64)
    return re * zr - im * zi, re * zi + im * zr


def _complex_epilogue(ore: torch.Tensor, oim: torch.Tensor, alpha: complex,
                      beta: complex, c: Optional[torch.Tensor]):
    """alpha * out + beta * c of a complex call, as the JAX package's
    `_jit_epi_c128` (float64 parts: `_cscale` of out by alpha and of c,
    widened exactly, by beta, then the sums) or `_jit_epi_c64` (float32
    parts: alpha and beta rounded to f32 and c narrowed to complex64; the
    full complex formula even for a real alpha, so out * 0 terms are taken;
    then (ore + cr*br) - ci*bi and (oim + cr*bi) + ci*br). Each multiply,
    add and subtract is its own tensor operation, so each is rounded once
    and nothing contracts into an FMA (ROADMAP C9); no torch complex
    arithmetic runs."""
    dt = ore.dtype
    if c is not None:
        cr, ci = _cg.canon_complex(c)
        cr, ci = cr.to(dt), ci.to(dt)
    if dt == torch.float64:
        if alpha != 1.0:
            ore, oim = _cscale(ore, oim, alpha)
        if beta != 0.0:
            tre, tim = _cscale(cr, ci, beta)
            ore, oim = ore + tre, oim + tim
        return ore, oim

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    if alpha != 1.0:
        ar, ai = f32(alpha.real), f32(alpha.imag)
        ore, oim = ore * ar - oim * ai, ore * ai + oim * ar
    if beta != 0.0:
        br, bi = f32(beta.real), f32(beta.imag)
        ore = ore + cr * br - ci * bi
        oim = oim + cr * bi + ci * br
    return ore, oim


def gemm(
    a: ArrayLike,
    b: ArrayLike,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[ArrayLike] = None,
    num_moduli: int = 14,
    fastmode: bool = True,
    compute_type: ComputeType = ComputeType.REAL_DEFAULT,
    out_dtype=None,
    moduli_chunk: Optional[int] = None,
    max_workspace_bytes: Optional[int] = None,
    n_panel: Optional[int] = None,
    op_a: str = "N",
    op_b: str = "N",
    return_times: bool = False,
    device=None,
) -> Union[torch.Tensor, tuple]:
    """Emulated GEMM: alpha * op_a(a) @ op_b(b) + beta * c, op(a) (m, k)
    and op(b) (k, n), on the operands' device.

    Real operands: float64 or float32 (float16 and bfloat16 widen to
    float32; a numpy array of another dtype becomes float32), in any
    combination; each is encoded at its own precision. The result is
    float64 or float32 by out_dtype (a torch or numpy dtype or a string;
    default: float64 if either operand is float64). op "N", "T" or "C"
    (the transpose, for a real operand). beta != 0 needs c (m, n), widened
    to float64 or narrowed to float32 with the output.

    Complex (either operand complex): complex128 and float64 operands are
    encoded in f64, complex64 and any other real dtype in f32, each at its
    own word (a c128 x c64 call is not widened); the result is complex128
    if either operand is (c128 or f64), else complex64, or by out_dtype (a
    complex torch or numpy dtype, "complex128", "complex64", "c128",
    "c64"). compute_type picks the strategy (real operands ignore it;
    REAL_DEFAULT means COMPLEX_BIG_MATRIX_ENCODE); all three give the same
    bits. op "C" conjugates by flipping the sign bit of every Im word.
    alpha and beta may be complex; beta != 0 needs c (m, n), real or
    complex, widened to complex128 or narrowed to complex64 with the
    output.

    num_moduli in [2, 20] trades accuracy for int8 GEMM count (DGEMM grade
    at about 14, SGEMM grade at about 8); fastmode=False picks the shifts
    from an extra int8 GEMM of 7-bit magnitudes, tighter at the same
    count. moduli_chunk (real operands) keeps only that many residue
    slices of each operand alive at a time, with the one-shot call's
    bits; max_workspace_bytes lets `planner.plan_schedule` pick the chunk
    for that budget. n_panel < n (real operands) makes B, its residues and
    the output n_panel columns at a time (the one-shot call's bits in fast
    mode; accurate mode takes each panel's shifts from that panel, as the
    JAX package does); n_panel >= n is the one-shot call. Tensor operands
    stay on their device; numpy operands go to `device`, by default the
    current card (RuntimeError without one: device="cpu" runs the plain
    versions on the CPU); a numpy c goes to the operands' device.

    return_times=True (real operands, one-shot schedule) returns (C,
    [encode, int8_gemms, mod_reduce, reconstruct] seconds), the phases of
    `gemm_timed`; alpha is then applied in the epilogue, never folded. With
    n_panel or a moduli chunk it raises NotImplementedError, as in the JAX
    package."""
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    for op in (op_a, op_b):
        if op not in ("N", "T", "C"):
            raise ValueError(f"op must be N/T/C, got {op}")
    if _is_complex_operand(a) or _is_complex_operand(b):
        return _gemm_complex(a, b, alpha, beta, c, num_moduli, fastmode,
                             compute_type, out_dtype, op_a, op_b, device,
                             moduli_chunk is not None
                             or max_workspace_bytes is not None
                             or n_panel is not None, return_times)
    ta = _as_tensor(_canon_real(a), device, "a")
    tb = _as_tensor(_canon_real(b), device, "b")
    if ta.device != tb.device:
        raise ValueError(f"a lies on {ta.device}, b on {tb.device}")
    ta, tb = _apply_op(ta, op_a), _apply_op(tb, op_b)
    kind = _out_kind(ta, tb, out_dtype)
    m, k, n = _g.check_shapes(ta, tb)
    if n_panel is not None:
        if moduli_chunk is not None or max_workspace_bytes is not None:
            raise ValueError("n_panel and moduli_chunk/max_workspace_bytes "
                             "are mutually exclusive schedules")
        if n_panel < 1:
            raise ValueError(f"n_panel={n_panel}: expected >= 1")
    if moduli_chunk is None and max_workspace_bytes is not None:
        moduli_chunk = _planner.plan_schedule(m, n, k, num_moduli,
                                              max_workspace_bytes).chunk
    if return_times and (n_panel is not None or moduli_chunk is not None):
        raise NotImplementedError("return_times is for the one-shot "
                                  "schedule")
    tc = None
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        tc = _as_tensor(c, device if device is not None else ta.device, "c")
        _check_c(tc, m, n, ta.device)
    if return_times:
        # as the JAX package: the timed phases, then alpha in the epilogue
        # (a power-of-two alpha is not folded)
        out, times = _timed_core(ta, tb, num_moduli, fastmode, kind, 1)
        return _epilogue(out, float(alpha), float(beta), tc), times
    # a power-of-two alpha folds into the reconstruct's exponent: exact
    # (the product is rounded once at the folded scale) and free
    alpha_e = 0
    if beta == 0.0:
        e = pow2_exponent(alpha)
        if e is not None:
            alpha_e, alpha = e, 1.0
    if n_panel is not None and n_panel < n:
        out = _g.gemm_core_panels(ta, tb, num_moduli, fastmode, kind,
                                  n_panel, alpha_e=alpha_e)
    else:
        out = _g.gemm_core(ta, tb, num_moduli, fastmode, kind, moduli_chunk,
                           alpha_e=alpha_e)
    return _epilogue(out, float(alpha), float(beta), tc)


def _is_complex_operand(x) -> bool:
    if isinstance(x, np.ndarray):
        return np.iscomplexobj(x)
    return isinstance(x, torch.Tensor) and x.is_complex()


def _gemm_complex(a, b, alpha, beta, c, num_moduli, fastmode, compute_type,
                  out_dtype, op_a, op_b, device, schedule, return_times):
    """The complex call of `gemm`, as the JAX package's `gemm_complex`:
    each operand's parts of op(x) at its own word, the complex core, the
    real power-of-two alpha fold, the epilogue of the output's kind."""
    if schedule:
        raise NotImplementedError(
            "moduli_chunk / max_workspace_bytes / n_panel are only "
            "supported on the real path (the reference's low-memory "
            "mode is likewise real-only)")
    if return_times:
        raise NotImplementedError(
            "return_times on a complex call: complex calls have no phase "
            "times in either package (the JAX package drops the argument "
            "without a word, ROADMAP C1)")
    # a real numpy array of another dtype than float64 becomes float32
    # here, a tensor in `canon_complex`
    ta = _as_tensor(_canon_real(a) if isinstance(a, np.ndarray) else a,
                    device, "a")
    tb = _as_tensor(_canon_real(b) if isinstance(b, np.ndarray) else b,
                    device, "b")
    if ta.device != tb.device:
        raise ValueError(f"a lies on {ta.device}, b on {tb.device}")
    kinds = (_cg.complex_kind(ta), _cg.complex_kind(tb))
    kind = _complex_out_kind(kinds, out_dtype)
    a_re, a_im = _cg.canon_complex(ta, op_a)
    b_re, b_im = _cg.canon_complex(tb, op_b)
    m, _, n = _g.check_shapes(a_re, b_re)
    alpha, beta = complex(alpha), complex(beta)
    tc = None
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        tc = _as_tensor(c, device if device is not None else ta.device, "c")
        _check_c(tc, m, n, ta.device, complex_ok=True)
    # a real power-of-two alpha folds into the reconstruct's exponent
    e_extra = 0
    if beta == 0.0 and alpha.imag == 0.0:
        e = pow2_exponent(alpha.real)
        if e is not None:
            e_extra, alpha = e, 1.0 + 0.0j
    re, im = _cg.gemm_complex_core(a_re, a_im, b_re, b_im, num_moduli,
                                   fastmode, compute_type,
                                   "f64" if kind == "c128" else "f32",
                                   e_extra=e_extra)
    if alpha != 1.0 or beta != 0.0:
        re, im = _complex_epilogue(re, im, alpha, beta, tc)
    return torch.complex(re, im)


def gemm_batched(a: ArrayLike, b: ArrayLike, *, num_moduli: int = 14,
                 fastmode: bool = True, out_dtype=None,
                 compute_type: ComputeType = ComputeType.REAL_DEFAULT,
                 device=None) -> torch.Tensor:
    """Strided-batch emulated GEMM: a (B, m, k) x b (B, k, n) -> (B, m, n),
    each element the bits of `gemm` on it (alpha 1, beta 0, op N). Real
    operands take `gemm`'s dtypes and out_dtype; complex ones (either
    operand complex) its complex dtypes, complex out_dtype spellings and
    compute_type. The elements run one after the other (the JAX package's
    `lax.map` on the TPU is sequential too) into one preallocated output.
    numpy operands go to `device`, by default the card, as in `gemm`."""
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    if _is_complex_operand(a) or _is_complex_operand(b):
        return _gemm_batched_complex(a, b, num_moduli, fastmode, out_dtype,
                                     compute_type, device)
    ta = _as_tensor(_canon_real(a), device, "a")
    tb = _as_tensor(_canon_real(b), device, "b")
    if ta.device != tb.device:
        raise ValueError(f"a lies on {ta.device}, b on {tb.device}")
    _check_batch(ta, tb)
    kind = _out_kind(ta, tb, out_dtype)
    out = torch.empty((ta.shape[0], ta.shape[1], tb.shape[2]),
                      dtype=torch.float32 if kind == "f32" else
                      torch.float64, device=ta.device)
    for i in range(ta.shape[0]):
        out[i] = _g.gemm_core(ta[i], tb[i], num_moduli, fastmode, kind)
    return out


def _check_batch(a: torch.Tensor, b: torch.Tensor) -> None:
    """ValueError unless a (B, m, k) and b (B, k, n) have one batch and one
    inner size within the int32-exactness bound."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError("gemm_batched expects 3D (batch, rows, cols)")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"batch shapes mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.shape[2] > tables.MAX_K:
        raise ValueError("k exceeds the int32-exactness bound 2^17")


def _gemm_batched_complex(a, b, num_moduli, fastmode, out_dtype,
                          compute_type, device):
    """The complex batch of `gemm_batched`: each element's parts at each
    operand's own word (`canon_complex`), then `gemm_complex_core`. The
    output kind is `_complex_out_kind`'s, so a real out_dtype spelling
    raises (the JAX package reads it as complex64, ROADMAP C1)."""
    ta = _as_tensor(_canon_real(a) if isinstance(a, np.ndarray) else a,
                    device, "a")
    tb = _as_tensor(_canon_real(b) if isinstance(b, np.ndarray) else b,
                    device, "b")
    if ta.device != tb.device:
        raise ValueError(f"a lies on {ta.device}, b on {tb.device}")
    kind = _complex_out_kind((_cg.complex_kind(ta), _cg.complex_kind(tb)),
                             out_dtype)
    _check_batch(ta, tb)
    parts = "f64" if kind == "c128" else "f32"
    out = torch.empty((ta.shape[0], ta.shape[1], tb.shape[2]),
                      dtype=torch.complex128 if kind == "c128" else
                      torch.complex64, device=ta.device)
    for i in range(ta.shape[0]):
        re, im = _cg.gemm_complex_core(*_cg.canon_complex(ta[i]),
                                       *_cg.canon_complex(tb[i]), num_moduli,
                                       fastmode, compute_type, parts)
        out[i] = torch.complex(re, im)
    return out


def gemm_timed(a: ArrayLike, b: ArrayLike, *, num_moduli: int = 14,
               fastmode: bool = True, out_dtype=None, iters: int = 1,
               device=None):
    """`gemm` of real operands on the default one-shot kernels, timed phase
    by phase, the reference's four-part breakdown: returns (C, [encode,
    int8_gemms, mod_reduce, reconstruct] seconds). One untimed warm-up
    runs every phase; then each phase runs `iters` times and its time is
    the mean. On the card each phase is timed with CUDA events on the
    operands' stream; on the CPU with the host clock. The mod runs in the
    GEMM's epilogue, so its phase is the identity and reads about 0. C has
    the default call's bits. numpy operands go to `device`, by default the
    card, as in `gemm`."""
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    if iters < 1:
        raise ValueError(f"iters={iters}: expected >= 1")
    if _is_complex_operand(a) or _is_complex_operand(b):
        raise TypeError("gemm_timed takes real operands")
    ta = _as_tensor(_canon_real(a), device, "a")
    tb = _as_tensor(_canon_real(b), device, "b")
    if ta.device != tb.device:
        raise ValueError(f"a lies on {ta.device}, b on {tb.device}")
    kind = _out_kind(ta, tb, out_dtype)
    return _timed_core(ta, tb, num_moduli, fastmode, kind, iters)


def _timed_core(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
                fastmode: bool, kind: str, iters: int):
    """(C, the four phases' mean seconds over iters runs each) after one
    untimed run of every phase, which also makes each phase's inputs."""
    p_enc, p_mm, p_mod, p_rec = _g.gemm_phases(a, b, num_moduli, fastmode,
                                               kind)
    a8, sft_a, b8, sft_b = p_enc(a, b)
    r8 = p_mm(a8, b8)
    r = p_mod(r8)
    out = p_rec(r, sft_a, sft_b)
    phases = [(p_enc, (a, b)), (p_mm, (a8, b8)), (p_mod, (r8,)),
              (p_rec, (r, sft_a, sft_b))]
    return out, [_phase_seconds(fn, args, iters, a.device)
                 for fn, args in phases]


def _phase_seconds(fn, args, iters: int, device: torch.device) -> float:
    """Mean seconds of fn(*args) over iters runs: CUDA events around them
    on the device's current stream, or the host clock on the CPU (no
    sync-cost estimate is taken off, so a time is never clamped to 0, the
    JAX package's CPU defect, ROADMAP C1)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            fn(*args)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


def workspace_bytes(m: int, n: int, k: int, num_moduli: int,
                    compute_type: ComputeType = ComputeType.REAL_DEFAULT,
                    moduli_chunk: Optional[int] = None) -> int:
    """Expected peak auxiliary bytes on the device for one call: the
    planner's model of what the port holds live (`planner.workspace_bytes`),
    for capacity planning and for choosing `max_workspace_bytes`."""
    return _planner.workspace_bytes(m, n, k, num_moduli, compute_type,
                                    moduli_chunk)
