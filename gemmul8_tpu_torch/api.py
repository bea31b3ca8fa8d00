"""Public front end: C = A @ B emulated in f64 with Ozaki Scheme II.

Counterpart of `gemmul8_tpu/api.py` `gemm` and `workspace_bytes`, for the
part of its surface that is ported: float64 x float64 -> float64 and
complex128 (or float64 mixed with complex128) -> complex128 under all three
complex compute types, op N/N, alpha = 1, beta = 0, fast and accurate mode;
for real operands the one-shot schedule (and under GEMMUL8_PIPELINE its
panel/rider pipeline), the moduli-chunked low-memory one (`moduli_chunk`,
or `max_workspace_bytes` through the planner) and the column-panel one
(`n_panel`). Every other argument value raises NotImplementedError naming
the ROADMAP item that adds it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import planner as _planner
from . import tables
from .core import complexgemm as _cg
from .core import gemm as _g
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
    device = _device(device)
    if isinstance(x, np.ndarray):
        if device is None:
            raise ValueError(f"{name} is a numpy array: pass device= "
                             "explicitly")
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    elif not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor or numpy array")
    elif device is not None and x.device != device:
        raise ValueError(f"{name} lies on {x.device}, not on {device}")
    return x


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
) -> torch.Tensor:
    """Emulated DGEMM: a (m, k) @ b (k, n) as a float64 tensor on the
    operands' device, or as a complex128 tensor when either operand is
    complex128 (the other may be float64). num_moduli in [2, 20] trades
    accuracy for int8 GEMM count (DGEMM grade at about 14); fastmode=False
    picks the shifts from an extra int8 GEMM of 7-bit magnitudes, tighter
    at the same count. compute_type picks the complex strategy (real
    operands ignore it; REAL_DEFAULT means COMPLEX_BIG_MATRIX_ENCODE); all
    three give the same bits. moduli_chunk (real operands) keeps only that
    many residue slices of each operand alive at a time, with the one-shot
    call's bits; max_workspace_bytes lets `planner.plan_schedule` pick the
    chunk for that budget. n_panel < n (real operands) makes B, its
    residues and the output n_panel columns at a time (the one-shot call's
    bits in fast mode; accurate mode takes each panel's shifts from that
    panel, as the JAX package does); n_panel >= n is the one-shot call.
    numpy operands need device=."""
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    if alpha != 1.0 or beta != 0.0 or c is not None:
        raise NotImplementedError("alpha/beta epilogue: ROADMAP A4")
    if op_a != "N" or op_b != "N":
        raise NotImplementedError("op T/C: ROADMAP A4")
    ta = _as_tensor(a, device, "a")
    tb = _as_tensor(b, device, "b")
    if ta.device != tb.device:
        raise ValueError(f"a lies on {ta.device}, b on {tb.device}")
    schedule = (moduli_chunk is not None or max_workspace_bytes is not None
                or n_panel is not None)
    if ta.is_complex() or tb.is_complex():
        if out_dtype is not None and out_dtype not in (
                torch.complex128, np.complex128, "complex128", "c128"):
            raise NotImplementedError(f"out_dtype {out_dtype}: ROADMAP A4")
        if schedule:
            raise NotImplementedError(
                "moduli_chunk / max_workspace_bytes / n_panel are only "
                "supported on the real path (the reference's low-memory "
                "mode is likewise real-only)")
        if return_times:
            raise NotImplementedError("phase times: ROADMAP A8")
        a_re, a_im = _cg.canon_complex(ta)
        b_re, b_im = _cg.canon_complex(tb)
        re, im = _cg.gemm_complex_core(a_re, a_im, b_re, b_im, num_moduli,
                                       fastmode, compute_type)
        return torch.complex(re, im)
    for x in (ta, tb):
        if x.dtype != torch.float64:
            raise NotImplementedError(
                f"{x.dtype} operands: ROADMAP A4 (only float64 and "
                "complex128 are ported)")
    if out_dtype is not None and out_dtype not in (torch.float64, np.float64,
                                                   "float64", "f64"):
        raise NotImplementedError(f"out_dtype {out_dtype}: ROADMAP A4")
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
    if return_times:
        raise NotImplementedError("phase times: ROADMAP A8")
    if n_panel is not None and n_panel < n:
        return _g.gemm_core_panels(ta, tb, num_moduli, fastmode, "f64",
                                   n_panel)
    return _g.gemm_core(ta, tb, num_moduli, fastmode, "f64", moduli_chunk)


def workspace_bytes(m: int, n: int, k: int, num_moduli: int,
                    compute_type: ComputeType = ComputeType.REAL_DEFAULT,
                    moduli_chunk: Optional[int] = None) -> int:
    """Expected peak auxiliary bytes on the device for one call: the
    planner's model of what the port holds live (`planner.workspace_bytes`),
    for capacity planning and for choosing `max_workspace_bytes`."""
    return _planner.workspace_bytes(m, n, k, num_moduli, compute_type,
                                    moduli_chunk)
