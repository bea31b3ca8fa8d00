"""The one generator of calls: a configuration and a traffic mix, made
into the operands of one step from the seed.

A traffic file (`traffic/<mix>.json`) holds parameters only:

    calls   the calls of one step, in order; each may give m, n, k (by
            default the configuration's), alpha (1) and beta (0)

Each call draws its own A, B (and C where beta != 0). Elements are
upstream's phi-matrices, (uniform - 0.5) * exp(normal * phi), drawn on
the device in float64 by one `torch.Generator` seeded with the seed, in
the order A, B, C of each call, the real part before the imaginary one,
and rounded once to the configuration's word. The same seed gives the
same operands.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import work as W

DTYPES = {"float64": (torch.float64, False), "float32": (torch.float32, False),
          "complex128": (torch.float64, True),
          "complex64": (torch.float32, True)}


@dataclass
class Call:
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor | None
    alpha: float
    beta: float


@dataclass
class Plan:
    calls: list
    num_moduli: int
    fastmode: bool
    complex_: bool
    flops_per_step: float
    work_per_step: list   # one {phase: Work} per call


def phi_matrix(rows: int, cols: int, phi: float, gen: torch.Generator,
               device) -> torch.Tensor:
    u = torch.rand((rows, cols), generator=gen, dtype=torch.float64,
                   device=device)
    g = torch.randn((rows, cols), generator=gen, dtype=torch.float64,
                    device=device)
    return u.sub_(0.5).mul_(g.mul_(phi).exp_())


def operand(rows: int, cols: int, cfg: dict, gen, device) -> torch.Tensor:
    part, complex_ = DTYPES[cfg["dtype"]]
    re = phi_matrix(rows, cols, cfg["phi"], gen, device).to(part)
    if not complex_:
        return re
    im = phi_matrix(rows, cols, cfg["phi"], gen, device).to(part)
    return torch.complex(re, im)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def make_plan(cfg: dict, traffic: dict, seed: int, device) -> Plan:
    part, complex_ = DTYPES[cfg["dtype"]]
    word = torch.finfo(part).bits // 8
    gen = generator(seed, device)
    calls, works, flops = [], [], 0.0
    for entry in traffic["calls"]:
        m = int(entry.get("m", cfg["m"]))
        n = int(entry.get("n", cfg["n"]))
        k = int(entry.get("k", cfg["k"]))
        alpha = float(entry.get("alpha", 1.0))
        beta = float(entry.get("beta", 0.0))
        a = operand(m, k, cfg, gen, device)
        b = operand(k, n, cfg, gen, device)
        c = operand(m, n, cfg, gen, device) if beta != 0.0 else None
        calls.append(Call(a, b, c, alpha, beta))
        works.append(W.call_work(m, n, k, cfg["num_moduli"], word, word,
                                 complex_))
        flops += W.useful_flops(m, n, k, complex_)
    return Plan(calls, int(cfg["num_moduli"]), bool(cfg["fastmode"]),
                complex_, flops, works)
