"""Wrappers of the probe kernels, beside their plain versions.

    clz        csrc/probe_clz.cu      <- scripts/probe_clz.py main
    vpu_chain  csrc/probe_vpu_ops.cu  <- scripts/probe_vpu_ops.py main
    mxu_crt    csrc/probe_mxu_crt.cu  <- scripts/probe_mxu_crt.py _build
    deaddep    csrc/probe_deaddep.cu  <- scripts/probe_deaddep.py build
               (matmul_mod's wgmma kernel with the injected work)

As in `hopper/kernels.py`: a CPU tensor takes the plain version (in
`gemmul8_tpu_torch/probes/`), a CUDA tensor launches the kernel or raises;
nothing falls back. Each launch counts in `build.LAUNCHES` under a key of
its variant, e.g. "probe_deaddep[hbmio]", "probe_vpu_ops[i32 mul]".
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..probes import clz as pclz
from ..probes import deaddep as pdd
from ..probes import mxu_crt as pmxu
from ..probes import vpu_ops as pvpu
from . import build
from . import launch
from .kernels import _on_cpu, crt_mma_table, crt_table_entry

clz_plain = pclz.clz_plain
vpu_chain_plain = pvpu.chain_plain
mxu_crt_plain = pmxu.mxu_crt_plain
deaddep_plain = pdd.deaddep_plain

def _launch(name: str, key: str, device: torch.device, made: tuple,
            *args) -> None:
    """Launch gm8_<name> on args, counted under "name[key]" with the
    tensors the wrapper made."""
    with torch.cuda.device(device):
        code = getattr(build.lib(), f"gm8_{name}")(
            *args, build.stream_ptr(device))
    build.check(code, name)
    build.launched(f"{name}[{key}]", *made)


def _check_count(x: torch.Tensor) -> None:
    if x.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2^31 words")


@trace.traced("gm8.hopper.clz")
def clz(x: torch.Tensor, form: str = "clz") -> torch.Tensor:
    """Leading zeros of each int32 word. form "clz": `__clz`, any word;
    "exp": the f32-exponent trick, for words in [0, 2^24) only (16-bit
    limbs). The CPU checks that range and raises; the card does not check
    it (the kernel is timed as it runs), and gives wrong counts for words
    outside it."""
    if form not in pclz.FORMS:
        raise ValueError(f"form {form!r}: one of {pclz.FORMS}")
    if x.dtype != torch.int32:
        raise TypeError("clz takes int32 words")
    if _on_cpu(x):
        if form == "exp" and x.numel() and (int(x.min()) < 0
                                            or int(x.max()) >= 1 << 24):
            raise ValueError("the exponent form takes words in [0, 2^24)")
        return clz_plain(x)
    build.require_cuda(x)
    _check_count(x)
    out = torch.empty_like(x)
    if x.numel():
        _launch("probe_clz", form, x.device, (out,), x.data_ptr(),
                out.data_ptr(), x.numel(), pclz.FORMS.index(form))
    return out


@trace.traced("gm8.hopper.vpu_chain")
def vpu_chain(x: torch.Tensor, case: str, steps: int = pvpu.STEPS):
    """One op chain of `probes.vpu_ops` over every element of x (int32 or
    float32, as the case): steps x REPS dependent ops."""
    if case not in pvpu.CASES:
        raise ValueError(f"case {case!r}: one of {pvpu.CASES}")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if _on_cpu(x):
        return vpu_chain_plain(x, case, steps)
    want = torch.int32 if case in pvpu.INT_CASES else torch.float32
    if x.dtype != want:
        raise TypeError(f"{case} takes {want}")
    build.require_cuda(x)
    _check_count(x)
    out = torch.empty_like(x)
    if x.numel():
        _launch("probe_vpu_ops", case, x.device, (out,), x.data_ptr(),
                out.data_ptr(), x.numel(), pvpu.CASES.index(case), steps)
    return out


@trace.traced("gm8.hopper.mxu_crt")
def mxu_crt(r: torch.Tensor, num_moduli: int, bm: int,
            variant: str = "full") -> torch.Tensor:
    """(m, n) int32 fold of the CRT contraction (`probes.mxu_crt`)."""
    pmxu.check_args(r, num_moduli, bm, variant)
    if _on_cpu(r):
        return mxu_crt_plain(r, num_moduli, bm, variant)
    build.require_cuda(r)
    m, n = pmxu.out_shape(r, bm, variant)
    out = torch.empty((m, n), dtype=torch.int32, device=r.device)
    if out.numel():
        table = crt_mma_table(num_moduli)
        _launch("probe_mxu_crt", variant, r.device, (out,), r.data_ptr(),
                out.data_ptr(), table.ctypes.data, num_moduli, m, n, bm,
                pmxu.VARIANTS.index(variant))
    return out


@trace.traced("gm8.hopper.deaddep")
def deaddep(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int, nops: int,
            variant: str, rin: torch.Tensor | None = None,
            stamps: torch.Tensor | None = None):
    """(residues, aux, rider output) of `probes.deaddep` in one launch of
    the GEMM with its injected work (and the copy of B K-major before
    it). stamps: a (tiles, 3) int64 tensor on the card that the kernel
    fills with each block's SM and SM clock at its start and end
    (`probes.deaddep.sm_cycles`); the CPU has no clock to give."""
    pdd.check_args(a8, b8, num_moduli, nops, variant, rin)
    if stamps is not None and (
            stamps.dtype != torch.int64 or not stamps.is_contiguous()
            or tuple(stamps.shape) != (pdd.tiles(a8.shape[-1], num_moduli),
                                       3)):
        raise ValueError("stamps: a contiguous (tiles, 3) int64 tensor")
    if _on_cpu(a8):
        if stamps is not None:
            raise ValueError("stamps are taken on the card only")
        return deaddep_plain(a8, b8, num_moduli, nops, variant, rin)
    tensors = [a8, b8] + [t for t in (rin, stamps) if t is not None]
    build.require_cuda(*tensors)
    # the GEMM is matmul_mod's kernel, built with the table's sm_90 entry;
    # any other card raises
    launch.get("matmul_mod", torch.cuda.get_device_capability(a8.device))
    if a8.data_ptr() % 16 or b8.data_ptr() % 16:
        raise ValueError("a8 and b8 must start on a 16-byte boundary")
    L, n = num_moduli, a8.shape[-1]
    dev = a8.device
    bt = torch.empty((L, n, n), dtype=torch.int8, device=dev)
    out = torch.empty((L, n, n), dtype=torch.uint8, device=dev)
    aux = (torch.empty(pdd.tiles(n, L), dtype=torch.int32, device=dev)
           if variant in pdd.CHAIN else None)
    rout = None
    if variant == "hbmio":
        rout = torch.empty_like(rin)
    elif variant in pdd.REC:
        rout = torch.empty(rin.shape[1], dtype=torch.float64, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    crt = crt_table_entry(L)
    mma = crt_mma_table(L)
    made = tuple(t for t in (bt, out, aux, rout) if t is not None)
    _launch("probe_deaddep", variant, dev, made, a8.data_ptr(),
            b8.data_ptr(), bt.data_ptr(), out.data_ptr(), ptr(rin),
            ptr(rout if variant == "hbmio" else None), ptr(aux),
            ptr(rout if variant in pdd.REC else None), crt.ctypes.data,
            mma.ctypes.data, L, n, pdd.VARIANTS.index(variant), nops // 2,
            ptr(stamps))
    build.copied_b(f"probe_deaddep[{variant}]")
    return out, aux, rout
