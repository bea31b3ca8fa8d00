"""python -m gemmul8_tpu_torch.probes {clz | vpu_ops | mxu_crt ... | deaddep ...}

    clz                                 probe_clz.py
    vpu_ops                             probe_vpu_ops.py
    mxu_crt lower                       build the kernel, run each variant once
    mxu_crt [time] [variant bm bn L m n]   default: full 16 512 14 8192 8192
    deaddep [n L nops ...]              default: 8192 14 0 16 32; nops -1
                                        runs recbody, -2 recmxu

Each subcommand needs a Hopper card (`bench.timing.require_gpu`) and exits
nonzero with a message without one.
"""

from __future__ import annotations

import sys

from ..bench.timing import require_gpu
from . import clz, deaddep, mxu_crt, vpu_ops

USAGE = __doc__.split("\n\n")[0]


def main(argv=None):
    """Run one probe; returns its results (ms by case or variant)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("clz", "vpu_ops", "mxu_crt", "deaddep"):
        print(f"usage: {USAGE}", file=sys.stderr)
        sys.exit(2)
    cmd, args = argv[0], argv[1:]
    require_gpu()
    if cmd == "clz":
        return clz.run()
    if cmd == "vpu_ops":
        return vpu_ops.run()
    if cmd == "mxu_crt":
        if args[:1] == ["lower"]:
            if not mxu_crt.lower():
                sys.exit(1)
            return {}
        if args[:1] == ["time"]:
            args = args[1:]
        variant = args[0] if args else mxu_crt.DEFAULTS[0]
        vals = list(mxu_crt.DEFAULTS[1:])
        for i, a in enumerate(args[1:6]):
            vals[i] = int(a)
        bm, bn, L, m, n = vals
        return mxu_crt.run(variant, bm, bn, L, m, n)
    n = int(args[0]) if args else deaddep.DEFAULTS[0]
    L = int(args[1]) if len(args) > 1 else deaddep.DEFAULTS[1]
    nops = [int(a) for a in args[2:]] or list(deaddep.DEFAULTS[2])
    return deaddep.run(n, L, nops)


if __name__ == "__main__":
    main()
