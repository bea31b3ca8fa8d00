"""Matmul interception: route torch matmuls through the emulator.

Counterpart of `gemmul8_tpu/interception.py`, the analog of the reference
hijack libraries' LD_PRELOAD shims (ozIMMU_EF/src/cublas.cu:283-300
re-exporting cublasDgemm_v2/Zgemm_v2; cuMpSGEMM's rule-callback dispatch,
src/default_cumpsgemm_rule.cu:6-50): inside `override_matmuls()` every
eligible `torch.matmul`, `torch.mm`, `Tensor.matmul`, `Tensor.mm`, `A @ B`,
two-operand `torch.einsum` spelling of a matmul and `torch.tensordot` with
one contracted dim a side, on 2-D float32, float64, complex64 or
complex128 operands, is computed by `gemmul8_tpu_torch.gemm` on the
operands' device (on the card: the hand-written kernels of the main
path). A user-supplied `rule` plays the role of cuMpSGEMM's
libcumpsgemm_rule.so: it sees (m, n, k, dtype) and picks the mode per
call. Calls below the intercept thresholds (env
GEMMUL8_INTERCEPT_THRESHOLD_*) pass through to native torch, like the
reference's size-gated passthrough (ozIMMU gemm.cu:241-264).

The hook is a `torch.overrides.TorchFunctionMode`, with two differences
from the JAX package's patched bindings:
- a mode is off inside its own handler, so the emulator's own torch calls
  are never intercepted again (the JAX module's `in_route` guard); nested
  contexts stack their settings under one mode, the innermost's in force;
- the mode is THREAD-LOCAL: it reroutes the matmuls of the thread that
  entered the context, and no other thread's, where the JAX patches are
  process-wide. `is_library_loaded` answers for the calling thread;
  `set_compute_mode`, the last-call name and the profile log stay
  process-wide, as in the JAX module.
Eager PyTorch has no tracing, so the JAX module's ":traced" profile label
has no counterpart. An operand that requires grad while grad mode is on
passes through: the emulator has no backward.

Per-call profiling (CULiP analog, ozIMMU_EF/src/culip.cu): with
GEMMUL8_PROFILE=1 or profile=True, every intercepted call is recorded
(shape, dtype, mode, wall time between two synchronizes of the operands'
card, the counterpart of the JAX module's fence) — read with
get_profile_log().
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from . import config as cfg
from . import tables
from .api import gemm

_PROFILE_LOG: list = []


@dataclass
class CallRecord:
    m: int
    n: int
    k: int
    dtype: str
    mode: str
    seconds: float


def get_profile_log():
    return list(_PROFILE_LOG)


def clear_profile_log():
    _PROFILE_LOG.clear()


def default_rule(m: int, n: int, k: int, dtype) -> str:
    """Default dispatch rule (cf. cuMpSGEMM default rule: small sizes ->
    native, default_cumpsgemm_rule.cu:13-15): 'emulate' above the
    thresholds, 'native' below."""
    c = cfg.get_config()
    if c.compute_mode == "off":
        return "native"
    if (m < c.intercept_threshold_m or n < c.intercept_threshold_n
            or k < c.intercept_threshold_k):
        return "native"
    return c.compute_mode


_ELIGIBLE = (torch.float32, torch.float64, torch.complex64, torch.complex128)

# ---------------------------------------------------------------------------
# Imperative hijack control (cuMpSGEMM hijack_control analog,
# include/cumpsgemm/hijack_control.hpp:10-33): set/unset a forced mode
# without entering a context manager, and query the last intercepted call.
# ---------------------------------------------------------------------------

_FORCED_MODE: Optional[str] = None
_LAST_FUNC: str = ""
_TLS = threading.local()   # .stack: this thread's override_matmuls settings


def set_compute_mode(mode: str) -> None:
    """Force every subsequent intercepted call to `mode` ('emulate' /
    'native'), overriding the rule callback."""
    global _FORCED_MODE
    if mode not in ("emulate", "native"):
        raise ValueError(mode)
    _FORCED_MODE = mode


def unset_compute_mode() -> None:
    global _FORCED_MODE
    _FORCED_MODE = None


def get_last_func_name() -> str:
    """Name+shape of the last intercepted matmul (hijack_control's
    last-called-function string), as the JAX module writes it:
    "matmul[MxKxN,float64]->emulate"."""
    return _LAST_FUNC


def is_library_loaded() -> bool:
    """True while override_matmuls is active in this thread — the analog
    of the python binding's is-the-hijack-in-place check (cuMpSGEMM
    LD_PRELOAD probe, python/src/main.cpp:34-39)."""
    return bool(_stack())


def enable_restoring_AB_after_scaling() -> None:
    """cuMpSGEMM API-parity no-ops (python/src/main.cpp:72-79): its
    SCALING mode rescales A/B in place on the GPU and optionally restores
    them afterwards. The emulator never writes the caller's operands, so
    there is nothing to restore and both toggles are accepted for
    compatibility."""


def disable_restoring_AB_after_scaling() -> None:
    """See enable_restoring_AB_after_scaling."""


@dataclass(frozen=True)
class _Settings:
    num_moduli: int
    fastmode: bool
    rule: Callable
    profile: bool


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float64"), as the JAX module
    prints it."""
    return str(dtype).replace("torch.", "")


def _eligible(a, b) -> bool:
    # BOTH operands must be emulatable 2-D tensors on one device: a mixed
    # f32 @ int32 call passes through to native torch
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        return False
    if a.dim() != 2 or b.dim() != 2 or a.device != b.device:
        return False
    if a.dtype not in _ELIGIBLE or b.dtype not in _ELIGIBLE:
        return False
    return not (torch.is_grad_enabled()
                and (a.requires_grad or b.requires_grad))


def _route(s: _Settings, a, b, native: Callable, op_a: str = "N",
           op_b: str = "N"):
    global _LAST_FUNC
    if not _eligible(a, b):
        return native()
    m, k = a.shape if op_a == "N" else a.shape[::-1]
    kb, n = b.shape if op_b == "N" else b.shape[::-1]
    if k > tables.MAX_K or k != kb:
        return native()
    mode = _FORCED_MODE or s.rule(m, n, k, a.dtype)
    name = _dtype_name(a.dtype)
    _LAST_FUNC = f"matmul[{m}x{k}x{n},{name}]->{mode}"
    cuda = a.device.type == "cuda"
    if s.profile and cuda:
        torch.cuda.synchronize(a.device)
    t0 = time.perf_counter()
    if mode == "native":
        out = native()
        label = "native"
    else:
        out = gemm(a, b, num_moduli=s.num_moduli, fastmode=s.fastmode,
                   op_a=op_a, op_b=op_b)
        label = f"emulate-{s.num_moduli}"
    if s.profile:
        if cuda:
            torch.cuda.synchronize(a.device)  # wall time, not enqueue time
        _PROFILE_LOG.append(CallRecord(m, n, k, name, label,
                                       time.perf_counter() - t0))
    cfg.log_info(f"intercepted matmul {m}x{k}x{n} {name} -> {mode}")
    return out


def _einsum_ops(args):
    """(a, b, op_a, op_b) of a two-operand einsum that spells a plain
    matmul ('ij,jk->ik' and its transposed forms), else None: the JAX
    module's `patched_einsum` rules."""
    if len(args) != 3 or not isinstance(args[0], str):
        return None
    sub = args[0].replace(" ", "")
    lhs, arrow, out_sub = sub.partition("->")
    if arrow and not out_sub:
        # explicit scalar output ('ij,jk->'): a full contraction, not a
        # matmul — indistinguishable from the implicit form once
        # partitioned, so check the separator itself
        return None
    parts = lhs.split(",")
    if len(parts) != 2:
        return None
    s1, s2 = parts
    if (len(s1) != 2 or len(s2) != 2 or len(set(s1)) != 2
            or len(set(s2)) != 2):
        return None
    shared = set(s1) & set(s2)
    if len(shared) != 1:
        return None
    c = shared.pop()
    expected = s1.replace(c, "") + s2.replace(c, "")
    if out_sub and out_sub != expected:
        return None
    if not out_sub and expected != "".join(sorted(expected)):
        # implicit output is alphabetical; a reversed result is a
        # transposed matmul — leave it to einsum
        return None
    return (args[1], args[2], "N" if s1[1] == c else "T",
            "N" if s2[0] == c else "T")


def _dims_side(d):
    """One side of tensordot's dims as a tuple of ints, or None."""
    if isinstance(d, int):
        return (d,)
    if isinstance(d, (list, tuple)) and all(isinstance(v, int) for v in d):
        return tuple(d)
    return None


def _tensordot_ops(args, kwargs):
    """(a, b, op_a, op_b) of a tensordot that contracts one dim of each 2-D
    operand (the counterpart of the JAX module's dot_general rule), else
    None. out= or any other keyword passes through."""
    kw = dict(kwargs)
    dims = kw.pop("dims", args[2] if len(args) > 2 else 2)
    if kw.pop("out", None) is not None or kw or len(args) not in (2, 3):
        return None
    a, b = args[0], args[1]
    if isinstance(dims, int):
        if dims != 1:
            return None
        lc, rc = (1,), (0,)
    elif isinstance(dims, (list, tuple)) and len(dims) == 2:
        lc, rc = _dims_side(dims[0]), _dims_side(dims[1])
        if lc is None or rc is None or len(lc) != 1 or len(rc) != 1:
            return None
        lc, rc = (lc[0] % 2,), (rc[0] % 2,)
    else:
        return None
    return a, b, "N" if lc == (1,) else "T", "N" if rc == (0,) else "T"


_MATMULS = {torch.matmul, torch.mm, torch.Tensor.matmul, torch.Tensor.mm,
            torch.Tensor.__matmul__}


class _Intercept(TorchFunctionMode):
    """The mode override_matmuls enters: routes the matmul spellings,
    passes every other call through. Torch turns the mode off while its
    handler runs, so `gemm`'s own torch calls are not intercepted."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def native():
            return func(*args, **kwargs)

        s = _stack()[-1]
        if func in _MATMULS:
            if kwargs or len(args) != 2:
                return native()
            return _route(s, args[0], args[1], native)
        if func is torch.Tensor.__rmatmul__:
            if kwargs or len(args) != 2:
                return native()
            return _route(s, args[1], args[0], native)
        if func is torch.einsum:
            ops = None if kwargs else _einsum_ops(args)
        elif func is torch.tensordot:
            ops = _tensordot_ops(args, kwargs)
        else:
            return native()
        if ops is None:
            return native()
        a, b, op_a, op_b = ops
        return _route(s, a, b, native, op_a, op_b)


@contextlib.contextmanager
def override_matmuls(num_moduli: Optional[int] = None,
                     fastmode: Optional[bool] = None,
                     rule: Optional[Callable] = None,
                     profile: Optional[bool] = None):
    """Context that reroutes torch.matmul / torch.mm / Tensor.matmul /
    Tensor.mm / the @ operator / two-operand torch.einsum matmul spellings
    / torch.tensordot with one contracted dim a side, on eligible 2-D
    f32/f64/complex operands, through the emulator; other calls pass
    through.

    Scope: the calling THREAD only (a TorchFunctionMode is thread-local),
    not the process as the JAX package's patches are. Nesting is handled:
    an inner context's settings are in force until it exits, and every
    exit, also by an exception, restores what was in force before."""
    c = cfg.get_config()
    settings = _Settings(
        num_moduli if num_moduli is not None else c.num_moduli,
        fastmode if fastmode is not None else c.fastmode,
        rule or default_rule,
        profile if profile is not None else c.profile)
    st = _stack()
    st.append(settings)
    try:
        if len(st) == 1:
            with _Intercept():
                yield
        else:
            yield
    finally:
        st.pop()
