"""Benchmark and accuracy harness with CSV output.

Counterpart of `gemmul8_tpu/bench/harness.py`, the reference's testing
executables' protocols (test_double.cu, test_float.cu,
test_float_complex.cu): `accuracy_check` sweeps num_moduli x phi x k and
reports max / median relative error against a double-double reference;
`time_check` sweeps sizes and reports the four-phase breakdown and TFLOP/s
of the emulator beside comparison rows (the native matmul, the raw
INT8-GEMM probe, the OS-I baseline, BF16X3-SCALING); `watt_check` adds the
card's power draw. The rows have the JAX package's fields and `func`
labels, and the CSVs its names (`oz2_results_{tag}_{device}_{stamp}.csv`),
written under `outdir` (default `results/`).

The accuracy half runs on `device` ("cuda" unless the caller passes
"cpu"). Every timed row runs on the card only (`require_gpu` exits nonzero
without one; nothing is timed on the CPU), by `timing.chained_time`: each
step adds 0 times the previous step's checksum to one element of an
operand (the value is unchanged, the step depends on the one before),
runs the call and sums a 64-strided grid of its output as the next
checksum. Native f32 and complex64 matmuls run with TF32 off.
"""

from __future__ import annotations

import csv
import datetime
import os
import time

import numpy as np
import torch

ACCURACY_FIELDS = ["phi", "m", "n", "k", "func", "max_relerr", "med_relerr"]
# the JAX package's time fields, then the SM clock and power draw that
# nvidia-smi read while the row's timed calls ran
TIME_FIELDS = ["phi", "m", "n", "k", "func", "seconds", "tflops", "t_scale",
               "t_int8gemm", "t_mod", "t_invscale", "sm_mhz", "power_draw_w"]
AXPBY = (1.7, -0.3)      # the OS2-fast-L-axpby row's alpha and beta
INT8_PROBE_MAX = 8192    # the INT8-GEMM probe's largest size
WATT_SECONDS = 10.0      # the reference's getWatt loop: at least 10 s a row,
WATT_INTERVAL_MS = 100   # the power draw read every 100 ms


def _device_name(device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev).replace(" ", "_")
    return "cpu"


def _stamp():
    return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def _csv_path(tag: str, outdir: str, device="cuda"):
    os.makedirs(outdir, exist_ok=True)
    return os.path.join(
        outdir, f"oz2_results_{tag}_{_device_name(device)}_{_stamp()}.csv")


class _RowSink:
    """Rows kept in a list and, with a path, streamed to its CSV as they
    come (a long sweep keeps its finished rows if it is killed)."""

    def __init__(self, path, fields):
        self.rows = []
        self.path = path
        self.file = open(path, "w", newline="") if path else None
        if self.file:
            self.writer = csv.DictWriter(self.file, fieldnames=fields)
            self.writer.writeheader()

    def __call__(self, row):
        self.rows.append(row)
        if self.file:
            self.writer.writerow(row)
            self.file.flush()

    def close(self):
        if self.file:
            self.file.close()


def _write_rows(rows, path, fields):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def _native_matmul(a: np.ndarray, b: np.ndarray, dtype, device):
    """torch.matmul of a and b cast to dtype, on device, TF32 off; as a
    numpy array."""
    from ..ops.mpgemm import no_tf32

    x = torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    y = torch.from_numpy(np.ascontiguousarray(b)).to(device, dtype)
    with no_tf32():
        return torch.matmul(x, y).cpu().numpy()


def accuracy_check(dtype: str = "d", sizes=(1024,), phis=(0.5,),
                   moduli=range(2, 21), fastmodes=(True, False),
                   m: int = 256, seed: int = 123456, outdir: str = "results",
                   write_csv: bool = True, device="cuda"):
    """Accuracy sweep on `device`. dtype 'd' (f64 out), 'f' (f32 out), 'md'
    (FP64 x FP32 -> FP64, the reference's test_mixed_double protocol) or
    'mf' (FP64 x FP32 -> FP32, test_mixed_float). Returns (rows [{phi, m,
    n, k, func, max_relerr, med_relerr}], CSV path or None). Ground truth:
    the dd GEMM of the cast operands (`native.dd_gemm`). The native row
    (DGEMM / SGEMM) is torch.matmul at the output's precision over the same
    cast operands."""
    from ..api import gemm
    from .matrices import phi_matrix
    from .native import dd_gemm, relerr_vs_dd

    if dtype not in ("d", "f", "md", "mf"):
        raise ValueError(f"dtype {dtype!r}: expected d, f, md or mf")
    out_is_f32 = dtype in ("f", "mf")
    out_dtype = torch.float32 if out_is_f32 else torch.float64
    max_l = 19 if out_is_f32 else 20
    emit = _RowSink(_csv_path(f"{dtype}_accuracy", outdir, device)
                    if write_csv else None, ACCURACY_FIELDS)
    try:
        for phi in phis:
            for k in sizes:
                a = phi_matrix(m, k, phi, seed)
                b = phi_matrix(k, m, phi, seed + 1)
                if dtype == "f":
                    a = a.astype(np.float32)
                if dtype in ("f", "md", "mf"):
                    b = b.astype(np.float32)   # md/mf: FP64 x FP32 operands
                ref_hi, ref_lo = dd_gemm(np.asarray(a, np.float64),
                                         np.asarray(b, np.float64))
                native = _native_matmul(a, b, out_dtype, device)
                mx, med = relerr_vs_dd(native.astype(np.float64), ref_hi,
                                       ref_lo)
                emit(dict(phi=phi, m=m, n=m, k=k,
                          func="SGEMM" if out_is_f32 else "DGEMM",
                          max_relerr=mx, med_relerr=med))
                for fast in fastmodes:
                    tag = "OS2-fast" if fast else "OS2-accu"
                    for L in moduli:
                        if L > max_l:
                            continue
                        c = gemm(a, b, num_moduli=L, fastmode=fast,
                                 out_dtype=out_dtype, device=device)
                        mx, med = relerr_vs_dd(
                            c.cpu().numpy().astype(np.float64), ref_hi,
                            ref_lo)
                        emit(dict(phi=phi, m=m, n=m, k=k, func=f"{tag}-{L}",
                                  max_relerr=mx, med_relerr=med))
    finally:
        emit.close()
    return emit.rows, emit.path


def _compute_types():
    from ..types import ComputeType

    return {"big": ComputeType.COMPLEX_BIG_MATRIX_ENCODE,
            "kara": ComputeType.COMPLEX_KARATSUBA_MULT,
            "classic": ComputeType.COMPLEX_CLASSIC_MULT}


def dd_cgemm(ar, ai, br, bi):
    """(hi, lo) dd pairs for Re and Im of (ar + i ai)(br + i bi): four real
    dd GEMMs, each exact to dd precision, combined by plain f64 adds
    (adequate for relative errors >= 1e-15)."""
    from .native import dd_gemm

    rr_h, rr_l = dd_gemm(ar, br)
    ii_h, ii_l = dd_gemm(ai, bi)
    ri_h, ri_l = dd_gemm(ar, bi)
    ir_h, ir_l = dd_gemm(ai, br)
    return ((rr_h - ii_h, rr_l - ii_l), (ri_h + ir_h, ri_l + ir_l))


def cerr(zre, zim, refs):
    """(max, median) relative error of a complex result: the larger of the
    Re part's and the Im part's, each against its dd reference (the
    per-part statistic the bands use)."""
    from .native import relerr_vs_dd

    (reh, rel_), (imh, iml) = refs
    mxr, medr = relerr_vs_dd(zre, reh, rel_)
    mxi, medi = relerr_vs_dd(zim, imh, iml)
    return max(mxr, mxi), max(medr, medi)


def accuracy_check_complex(sizes=(1024,), phis=(0.0, 0.5, 1.0, 1.5),
                           moduli=range(2, 20),
                           compute_types=("big", "kara", "classic"),
                           fastmodes=(True, False), m: int = 256,
                           seed: int = 123456, outdir: str = "results",
                           write_csv: bool = True, device="cuda"):
    """Complex (CGEMM emulation) accuracy sweep on `device`: the
    reference's test_float_complex protocol (complex64 in and out, the
    three complex strategies, phi in {0, 0.5, 1, 1.5}, moduli 2-19). The
    native row (CGEMM) is torch.matmul in complex64, TF32 off. Ground
    truth: `dd_cgemm` of the complex64 operands' parts."""
    from ..api import gemm
    from .matrices import phi_matrix

    ct_map = _compute_types()
    emit = _RowSink(_csv_path("c_accuracy", outdir, device)
                    if write_csv else None, ACCURACY_FIELDS)
    try:
        for phi in phis:
            for k in sizes:
                ar = phi_matrix(m, k, phi, seed)
                ai = phi_matrix(m, k, phi, seed + 1)
                br = phi_matrix(k, m, phi, seed + 2)
                bi = phi_matrix(k, m, phi, seed + 3)
                a = (ar + 1j * ai).astype(np.complex64)
                b = (br + 1j * bi).astype(np.complex64)
                refs = dd_cgemm(np.asarray(a.real, np.float64),
                                np.asarray(a.imag, np.float64),
                                np.asarray(b.real, np.float64),
                                np.asarray(b.imag, np.float64))
                nat = _native_matmul(a, b, torch.complex64, device)
                mx, med = cerr(np.asarray(nat.real, np.float64),
                               np.asarray(nat.imag, np.float64), refs)
                emit(dict(phi=phi, m=m, n=m, k=k, func="CGEMM",
                          max_relerr=mx, med_relerr=med))
                for fast in fastmodes:
                    for ct in compute_types:
                        for L in moduli:
                            if L > 19:
                                continue
                            z = gemm(a, b, num_moduli=L, fastmode=fast,
                                     compute_type=ct_map[ct], device=device)
                            z = np.asarray(z.cpu().numpy(), np.complex128)
                            tag = "fast" if fast else "accu"
                            mx, med = cerr(z.real.copy(), z.imag.copy(), refs)
                            emit(dict(phi=phi, m=m, n=m, k=k,
                                      func=f"OS2C-{ct}-{tag}-{L}",
                                      max_relerr=mx, med_relerr=med))
    finally:
        emit.close()
    return emit.rows, emit.path


# ---------------------------------------------------------------------------
# The timing half: the card only.
# ---------------------------------------------------------------------------


def _checksum(out: torch.Tensor) -> torch.Tensor:
    """f32 sum of a 64-strided grid of out (complex: of its Re and Im)."""
    grid = out[::64, ::64]
    if grid.is_complex():
        grid = torch.view_as_real(grid)
    return grid.to(torch.float32).sum()


def _threaded(fn, x: torch.Tensor, y: torch.Tensor):
    """chained_time's (step, state) for fn(x, y): each step adds 0 times
    the previous checksum to y[0, 0] (value-preserving), then returns y
    and the checksum of fn(x, y)."""
    def step(st):
        yy, chk = st
        yy[0, 0] += (0 * chk).to(yy.dtype)
        return yy, _checksum(fn(x, yy))

    return step, (y, torch.zeros((), dtype=torch.float32, device=y.device))


def _gemm_step(x, y, num_moduli: int, fastmode: bool, out_dtype=None,
               axpby=None, c=None, compute_type=None, n_panel=None):
    """(step, state) of the whole `gemm` call on x and the threaded y; with
    axpby=(alpha, beta), gemm(alpha=, beta=, c=c) (the epilogue on the
    card; c a numpy array or a CUDA tensor); with n_panel, the
    column-panel schedule."""
    from ..api import gemm

    kw = dict(num_moduli=num_moduli, fastmode=fastmode, out_dtype=out_dtype)
    if compute_type is not None:
        kw["compute_type"] = compute_type
    if n_panel is not None:
        kw["n_panel"] = n_panel
    if axpby is not None:
        if c is None:
            raise ValueError("axpby needs c, of the output's shape")
        kw.update(alpha=axpby[0], beta=axpby[1], c=_on_card(c))
    return _threaded(lambda p, q: gemm(p, q, **kw), x, y)


def _fused_gemm_seconds(a, b, num_moduli: int, fastmode: bool,
                        iters: int, out_dtype=None, axpby=None,
                        c=None, compute_type=None, n_panel=None) -> float:
    """Seconds per call of the whole production `gemm` call on the card, by
    `chained_time`: the protocol of every OS2 row of `time_check` and
    `time_check_complex`, and the one the port's benchmark times its call
    with. a, b: numpy arrays or CUDA tensors. axpby=(alpha, beta): the call
    with C = alpha AB + beta C, where c (m, n) is a C of the output's own
    shape (the JAX package sliced it out of A's bits, ROADMAP C1).
    n_panel: the column-panel call (`scripts/scale_bench.py`)."""
    from .timing import chained_time, require_gpu

    require_gpu()
    x, y = (_on_card(t) for t in (a, b))
    step, state = _gemm_step(x, y, num_moduli, fastmode, out_dtype, axpby, c,
                             compute_type, n_panel)
    dt, _ = chained_time(step, state, iters)
    return dt


def _on_card(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to("cuda")


def _time_row_names(dtype: str, num_moduli, fastmodes, include_osi):
    """The func labels of one size of `time_check`, in its order."""
    if dtype == "f":
        names = ["SGEMM"]
    else:
        # mixed operands: the matmul runs at a's (promoted) precision
        names = ["MIXED-DGEMM" if dtype in ("md", "mf") else "DGEMM"]
    names.append("INT8-GEMM")
    for fast in fastmodes:
        tag = "OS2-fast" if fast else "OS2-accu"
        for L in num_moduli:
            names.append(f"{tag}-{L}")
            if dtype == "d" and fast and L == max(num_moduli):
                names.append(f"{tag}-{L}-axpby")
    if dtype == "f":
        names.append("BF16X3-SCALING")
    if dtype == "d":
        names += [f"OS1-EF-{s}" for s in include_osi]
    return names


def _time_rows(dtype: str, n: int, phi: float, seed: int, names):
    """The rows `names` of one size of `time_check`: (func, size, make,
    call), make() -> (step, state) for chained_time, call the keywords of
    `_fused_gemm_seconds` for an OS2 row, else None. Operands live on the
    card."""
    from ..baselines import ozimmu
    from ..core import slicegemm as sg
    from ..ops import mpgemm as mp
    from .matrices import phi_matrix

    a = phi_matrix(n, n, phi, seed)
    b = phi_matrix(n, n, phi, seed + 1)
    if dtype == "f":
        a = a.astype(np.float32)
    if dtype in ("f", "md", "mf"):
        b = b.astype(np.float32)   # md/mf: FP64 x FP32 operands
    x, y = _on_card(a), _on_card(b)
    out_dtype = torch.float32 if dtype in ("f", "mf") else torch.float64

    def native(p, q):
        with mp.no_tf32():
            return torch.matmul(p, q)

    rows = []
    for func in names:
        size, call = n, None
        if func in ("DGEMM", "SGEMM", "MIXED-DGEMM"):
            # the mixed protocols' f32 b widened once, outside the steps
            def make():
                return _threaded(native, x, y.to(x.dtype))
        elif func == "INT8-GEMM":
            size = min(n, INT8_PROBE_MAX)

            def make(size=size):
                return sg.int8_probe_step(size)
        elif func.startswith("OS2-"):
            parts = func.split("-")
            call = dict(num_moduli=int(parts[2]), fastmode=parts[1] == "fast",
                        out_dtype=out_dtype)
            if len(parts) == 4:
                # the same call with the epilogue C = 1.7 AB - 0.3 C on a C
                # of the output's shape from its own seed: the difference
                # from the plain row is the epilogue's cost
                call.update(axpby=AXPBY, c=phi_matrix(n, n, phi, seed + 2))

            def make(call=call):
                return _gemm_step(x, y, **call)
        elif func == "BF16X3-SCALING":
            # the cuMpSGEMM FP16TCEC_SCALING comparison row (the
            # reference's f-time CSV has it): bf16x3 split-and-correct
            # SGEMM with dynamic power-of-two scaling
            def make():
                return _threaded(lambda p, q: mp.mp_gemm(
                    p, q, mp.Mode.SCALING, device=p.device), x, y)
        elif func.startswith("OS1-EF-"):
            def make(s=int(func.split("-")[2])):
                return _threaded(lambda p, q: ozimmu.ozimmu_gemm(
                    p, q, s, device=p.device), x, y)
        else:
            raise ValueError(f"no time_check row {func!r}")
        rows.append((func, size, make, call))
    return rows, x, y


def time_check(dtype: str = "d", sizes=(1024, 2048, 4096, 8192),
               num_moduli=(14,), fastmodes=(True,), phi: float = 0.5,
               iters: int = 5, seed: int = 123456, outdir: str = "results",
               include_osi=(8, 9), write_csv: bool = True):
    """Throughput sweep on the card (exits nonzero without one) with the
    reference's four-phase breakdown. Rows: the native matmul (DGEMM,
    SGEMM, or MIXED-DGEMM for the mixed protocols, TF32 off), the raw
    INT8-GEMM probe, OS2-{fast,accu}-L with gemm_timed's four phase
    columns (the row's seconds are the whole call's, by
    `_fused_gemm_seconds`), OS2-fast-L-axpby (dtype d, the largest L: the
    same call with alpha = 1.7, beta = -0.3 and a C of its own),
    BF16X3-SCALING (dtype f) and OS1-EF-s (dtype d, s in include_osi).
    Each row's `sm_mhz` and `power_draw_w` are the medians of nvidia-smi's
    samples (every 20 ms) while its timed calls ran, NaN where none landed
    in so short a window; the phase breakdown runs outside that window.

    dtype 'd' / 'f' / 'md' (FP64 x FP32 -> FP64) / 'mf' (FP64 x FP32 ->
    FP32); the mixed protocols time the mixed call beside the native and
    INT8 rows."""
    from ..api import gemm_timed
    from ..core import slicegemm as sg
    from .power import ClockSampler
    from .timing import chained_time, require_gpu

    if dtype not in ("d", "f", "md", "mf"):
        raise ValueError(f"dtype {dtype!r}: expected d, f, md or mf")
    require_gpu()
    rows = []
    for n in sizes:
        names = _time_row_names(dtype, num_moduli, fastmodes, include_osi)
        specs, x, y = _time_rows(dtype, n, phi, seed, names)
        for func, size, make, call in specs:
            phases = [np.nan] * 4
            with ClockSampler() as clock:
                if func == "INT8-GEMM":
                    tops = sg.int8_peak_probe(size, iters=iters)
                    seconds = 2.0 * size ** 3 / (tops * 1e12)
                elif call is not None:
                    seconds = _fused_gemm_seconds(x, y, iters=iters, **call)
                else:
                    seconds, _ = chained_time(*make(), iters)
            if call is not None and "axpby" not in call:
                _, phases = gemm_timed(x, y, iters=iters, **call)
            mhz, draw = clock.medians()
            rows.append(dict(phi=phi, m=size, n=size, k=size, func=func,
                             seconds=seconds,
                             tflops=2.0 * size ** 3 / seconds / 1e12,
                             t_scale=phases[0], t_int8gemm=phases[1],
                             t_mod=phases[2], t_invscale=phases[3],
                             sm_mhz=mhz, power_draw_w=draw))
        # free this size's operands before the next (larger) one
        del specs, x, y
        torch.cuda.empty_cache()
    if write_csv:
        path = _csv_path(f"{dtype}_time", outdir)
        _write_rows(rows, path, TIME_FIELDS)
        return rows, path
    return rows, None


def time_check_complex(sizes=(2048, 4096), num_moduli=(14,),
                       compute_types=("big", "kara", "classic"),
                       fastmodes=(True,), phi: float = 0.5,
                       iters: int = 5, seed: int = 123456,
                       outdir: str = "results", write_csv: bool = True):
    """Complex (CGEMM emulation) throughput sweep on the card: the
    reference's test_float_complex time protocol (TFLOPS = 2 m n k / time,
    the element-op convention the reference prints). Times the whole
    complex64 `gemm` call, operands and result complex64 on the card (the
    JAX module timed its core on separate Re / Im planes and left out a
    host complex assembly that TPU runtimes needed; the card needs none),
    by `_fused_gemm_seconds`, with time_check's `sm_mhz` and
    `power_draw_w`."""
    from .matrices import phi_matrix
    from .power import ClockSampler
    from .timing import require_gpu

    require_gpu()
    ct_map = _compute_types()
    rows = []
    for n in sizes:
        ar, ai, br, bi = (phi_matrix(n, n, phi, seed + i).astype(np.float32)
                          for i in range(4))
        x = _on_card((ar + 1j * ai).astype(np.complex64))
        y = _on_card((br + 1j * bi).astype(np.complex64))
        flops = 2.0 * n ** 3
        for fast in fastmodes:
            for ct in compute_types:
                for L in num_moduli:
                    with ClockSampler() as clock:
                        dt = _fused_gemm_seconds(x, y, L, fast, iters,
                                                 compute_type=ct_map[ct])
                    mhz, draw = clock.medians()
                    tag = "fast" if fast else "accu"
                    rows.append(dict(phi=phi, m=n, n=n, k=n,
                                     func=f"OS2C-{ct}-{tag}-{L}",
                                     seconds=dt, tflops=flops / dt / 1e12,
                                     sm_mhz=mhz, power_draw_w=draw))
                    print(f"{n}^3 {rows[-1]['func']}: {dt * 1e3:.2f} ms  "
                          f"{rows[-1]['tflops']:.2f} TFLOPS", flush=True)
        del x, y
        torch.cuda.empty_cache()
    if write_csv and rows:
        path = _csv_path("c_time", outdir)
        _write_rows(rows, path, list(rows[0].keys()))
        return rows, path
    return rows, None


def _loop_watts(step, state):
    """Run step over and over for at least WATT_SECONDS while nvidia-smi
    samples the power draw every WATT_INTERVAL_MS (the reference's getWatt
    protocol). Returns (seconds per step over the loop, mean watts, median
    SM clock MHz); raises if no power sample was read."""
    from .power import ClockSampler

    state = step(state)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = step(state)
    torch.cuda.synchronize()
    per_batch = max(1, int(0.1 / max(time.perf_counter() - t0, 1e-6)))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    steps = 0
    with ClockSampler(WATT_INTERVAL_MS) as clock:
        start.record()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WATT_SECONDS:
            for _ in range(per_batch):
                state = step(state)
            steps += per_batch
            torch.cuda.synchronize()      # at most ~0.1 s queued
        stop.record()
        torch.cuda.synchronize()
    watts = clock.watts()
    return start.elapsed_time(stop) * 1e-3 / steps, watts, clock.medians()[0]


def _row_spec(row, dtype: str, seed: int):
    """The (step, state) maker of a time_check row of `dtype`, rebuilt
    from its func, size and phi."""
    func, n = row["func"], int(row["n"])
    parts = func.split("-")
    num_moduli, fastmodes, include_osi = (), (), ()
    if func.startswith("OS2-") and len(parts) >= 3:
        num_moduli, fastmodes = (int(parts[2]),), (parts[1] == "fast",)
    elif func.startswith("OS1-EF-"):
        include_osi = (int(parts[2]),)
    if func not in _time_row_names(dtype, num_moduli, fastmodes,
                                   include_osi):
        raise ValueError(f"{func!r} is not a time_check row of dtype "
                         f"{dtype!r}")
    if func == "INT8-GEMM" and n > INT8_PROBE_MAX:
        raise ValueError(f"INT8-GEMM rows are at most {INT8_PROBE_MAX}")
    (spec,), *_ = _time_rows(dtype, n, float(row["phi"]), seed, [func])
    return spec[2]


def watt_check(dtype: str = "d", rows=None, seed: int = 123456, **sweep):
    """Power measurement on the card: each row's call runs in a loop of at
    least WATT_SECONDS while the power draw is sampled every
    WATT_INTERVAL_MS (the reference's getWatt.hpp protocol), and the row
    gets `watt` (the mean draw), `gflops_per_watt` (the loop's rate over
    it) and `watt_sm_mhz` (the loop's median SM clock).

    Without rows=, time_check(dtype, seed=seed, **sweep) runs first (sweep:
    its other keywords) and its rows are measured. With rows= (a
    time_check's rows of this dtype and seed), those rows are measured and
    annotated; giving rows= and sweep keywords together raises ValueError
    (the JAX package dropped the sweep arguments without a word, ROADMAP
    C1). Exits nonzero without a card; raises when no power sample can be
    read. Returns (rows, None)."""
    from .timing import require_gpu

    if rows is not None and sweep:
        raise ValueError("watt_check: pass rows= or time_check's sweep "
                         f"arguments, not both (got {sorted(sweep)})")
    require_gpu()
    if rows is None:
        rows, _ = time_check(dtype, seed=seed, write_csv=False, **sweep)
    for row in rows:
        step, state = _row_spec(row, dtype, seed)()
        seconds, watts, mhz = _loop_watts(step, state)
        n = int(row["n"])
        row["watt"] = watts
        row["gflops_per_watt"] = 2.0 * n ** 3 / seconds / 1e9 / watts
        row["watt_sm_mhz"] = mhz
        del step, state
        torch.cuda.empty_cache()
    return rows, None
