"""The work of a call's epilogue, C = alpha AB + beta C0, and its roofline.

Beside `work.py`'s four phases, an epilogue phase: it reads the product
(the tensor `work.call_work` calls "C", which the crt phase writes) and C0,
and writes the call's output, each once, in the output's word, two parts
an element for a complex call:

    beta != 0                  reads C and C0, writes out: 3 words an element
    alpha != 1, beta == 0      reads C, writes out: 2 words an element
    alpha == 1, beta == 0      no work

The device time of the epilogue is that of the operations no file under
`kernels/` assigns to a phase, and of those whose file names the phase
"epilogue". In a cell of real, contiguous operands the first are exactly
the epilogue's torch operations (`api._epilogue`'s multiplies and add):
the real path's other work all runs in the kernels the files name. A
kernel that takes the epilogue over, alone or with other phases, names
"epilogue" in its file, and its phases' work merges as `work.merge` merges
them (a fused reconstruct and epilogue no longer writes and reads C).
"""

from __future__ import annotations

from . import work as W

PHASE = "epilogue"


def epilogue_work(m: int, n: int, word: int, complex_: bool, alpha,
                  beta) -> W.Work:
    """The epilogue's Work for an (m, n) output held in `word` bytes a
    part."""
    size = (2 if complex_ else 1) * word * m * n
    if beta != 0:
        return W.Work(0.0, {"C": size, "C0": size}, {"out": size})
    if alpha != 1:
        return W.Work(0.0, {"C": size}, {"out": size})
    return W.Work()


def call_phases(plan) -> list:
    """{phase: Work} of each call of the plan, `work.call_work`'s phases
    and the epilogue."""
    out = []
    for call, phases in zip(plan.calls, plan.work_per_step):
        word = call.a.element_size() // (2 if plan.complex_ else 1)
        epi = epilogue_work(call.a.shape[0], call.b.shape[1], word,
                            plan.complex_, call.alpha, call.beta)
        out.append({**phases, PHASE: epi})
    return out


def roofline(trace, plan) -> float | None:
    """Percent: the bound of the traced steps' epilogue work (merged with
    the phases of any kernel that also does it) over the device time of
    the operations that did it; None where no such operation ran or no
    call has an epilogue."""
    group = trace.group(PHASE) or frozenset({PHASE})
    t_us = sum(o.dur for o in trace.device
               if not trace.phases_of[o.name]
               or trace.phases_of[o.name] & group)
    bound_ms = sum(W.bound_ms(W.merge(p, group))[0]
                   for p in call_phases(plan)) * trace.steps
    if t_us <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms * 1e3 / t_us
