"""epilogue_roofline: percent of the epilogue's byte bound (C = alpha AB +
beta C0: the product and C0 read once, C written once; the product and C
where beta is 0 and alpha is not 1; `epilogue_work.py`) over the device
time of the operations doing it: those no file under `kernels/` assigns
(in a cell of real, contiguous operands, exactly the epilogue's torch
operations) and those whose file names the phase "epilogue"."""

from portbench import epilogue_work


def read(ctx):
    if ctx.trace is None:
        return None
    return epilogue_work.roofline(ctx.trace, ctx.plan)
