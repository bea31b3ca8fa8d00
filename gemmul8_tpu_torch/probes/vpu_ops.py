"""Sustained op rates of dependent integer and f32 chains: counterpart of
`scripts/probe_vpu_ops.py` (`main`, its Pallas kernel: a (512, 512) block
held in fast memory while a sequential grid of STEPS steps applies REPS
dependent ops per step to every element).

On the card the sequential grid becomes a loop inside each thread, with
the element in registers (`csrc/probe_vpu_ops.cu`, one thread per
element). The nine chains are the script's (its lines 80-99). The rate is
reported with the JAX op count, M * N * REPS * STEPS, whatever number of
instructions a step takes on the card.

The chains answer how encode and reconstruct's integer and f32 work
should be written for the card's CUDA cores.
"""

from __future__ import annotations

import numpy as np
import torch

M, N = 512, 512
REPS = 16                  # dependent ops per step (unrolled)
STEPS = 2048               # steps over the same block
CASES = ("i32 mul", "i32 constmul", "i32 constmac", "i32 add", "i32 shr^",
         "f32 mul", "f32 constmac", "f32 floor", "f32->i32 cvt")
INT_CASES = frozenset(c for c in CASES if not c.startswith("f32 "))

# the f32 constants, as the script's np.float32 values
F_MAC_B, F_MAC_A = float(np.float32(1.0001)), float(np.float32(1e-6))
F_THIRD, F_FLOOR_K = float(np.float32(1 / 3)), float(np.float32(2.9999))
F_CVT = float(np.float32(1.5))
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def const_of(i: int) -> int:
    """The integer constant of rep i (the script's 2 * i + 179)."""
    return 2 * i + 179


def inputs(seed: int = 0) -> dict:
    """case -> (M, N) input of that chain, from one numpy seed (the script
    draws from numpy's global state)."""
    rng = np.random.default_rng(seed)
    ri = rng.integers(1, 1000, (M, N)).astype(np.int32)
    rf = rng.uniform(0.5, 2.0, (M, N)).astype(np.float32)
    out = {c: ri for c in CASES if c in INT_CASES}
    out["i32 mul"] = ri | 1
    out["f32 mul"] = rng.uniform(0.999, 1.001, (M, N)).astype(np.float32)
    out["f32 constmac"] = rf
    out["f32 floor"] = rng.uniform(100, 1000, (M, N)).astype(np.float32)
    return out


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 value of their low 32 bits, in int64."""
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _sat_trunc(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 toward zero, saturating as CUDA's cvt.rzi.s32.f32 (the
    values are finite here), in int64."""
    d = v.double()
    return torch.clamp(torch.trunc(d), _I32_MIN, _I32_MAX).to(torch.int64)


def body(case: str, b: torch.Tensor, a: torch.Tensor, i: int):
    """One rep of a chain: int chains on int64 tensors holding int32
    values, wrapped; f32 chains on float32 tensors, each operation its own
    rounding."""
    if case == "i32 mul":
        return _wrap(b * a)
    if case == "i32 constmul":
        return _wrap(b * const_of(i))
    if case == "i32 constmac":
        return _wrap(b * const_of(i) + a)
    if case == "i32 add":
        return _wrap(b + a)
    if case == "i32 shr^":
        return (b >> 1) ^ a
    if case == "f32 mul":
        return b * a
    if case == "f32 constmac":
        return b * F_MAC_B + a * F_MAC_A
    if case == "f32 floor":
        return b - torch.floor(b * F_THIRD) * F_FLOOR_K
    if case == "f32->i32 cvt":
        return _sat_trunc(b.float() * F_CVT) ^ a
    raise ValueError(f"unknown case {case!r}")


def chain_plain(x: torch.Tensor, case: str, steps: int = STEPS,
                reps: int = REPS) -> torch.Tensor:
    """The chain's output: b = x, then steps * reps reps of body(b, x, i),
    i the rep's place in its step. int32 or float32, as x."""
    want = torch.int32 if case in INT_CASES else torch.float32
    if x.dtype != want:
        raise TypeError(f"{case} takes {want}")
    a = x.to(torch.int64) if case in INT_CASES else x
    b = a
    for _ in range(steps):
        for i in range(reps):
            b = body(case, b, a, i)
    return b.to(want)


def ops(steps: int = STEPS) -> int:
    """The JAX op count of one chain call: M * N * REPS * steps."""
    return M * N * REPS * steps


def run(iters: int = 8) -> dict:
    """The probe on the card: each chain's ms per call and T op/s with the
    JAX op count; the call's output feeds the next call, as the script's
    serial chain."""
    from ..bench.timing import chained_time, require_gpu
    from ..hopper import probes as hp

    require_gpu()
    res = {}
    xs = inputs()
    for case in CASES:
        x = xs[case]
        sec, _ = chained_time(lambda s, c=case: hp.vpu_chain(s, c, STEPS),
                              torch.from_numpy(x).cuda(), iters)
        res[case] = sec * 1e3
        print(f"{case:14s} {sec * 1e3:7.3f} ms   "
              f"{ops() / sec / 1e12:6.2f} T op/s", flush=True)
    return res
