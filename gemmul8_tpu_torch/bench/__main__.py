"""CLI mirroring the reference test executables' interface, as
`python -m gemmul8_tpu.bench` does for the JAX package:

    python -m gemmul8_tpu_torch.bench [d|f] [accuracy_check|flops_check|watt_check|all]
        [--sizes 1024,2048] [--moduli 2-20] [--phi 0.5] [--outdir results]
        [--iters 5] [--device cuda] [--modes fast|accu|fast,accu]

accuracy_check runs on --device (default cuda; cpu runs the kernels' plain
versions); flops_check and watt_check run on the card only and exit
nonzero without one, their OS2 rows in the modes of --modes (default
fast, as the JAX package's CLI). Writes the CSV schema the reference's
plotting consumes.
"""

import argparse


def _parse_range(s: str):
    if "-" in s:
        a, b = s.split("-")
        return range(int(a), int(b) + 1)
    return [int(x) for x in s.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gemmul8_tpu_torch.bench")
    ap.add_argument("dtype", choices=["d", "f"], nargs="?", default="d")
    ap.add_argument("mode", nargs="?", default="all",
                    choices=["accuracy_check", "flops_check", "watt_check",
                             "all"])
    ap.add_argument("--sizes", default="1024")
    ap.add_argument("--moduli", default=None)
    ap.add_argument("--phi", type=float, default=0.5)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--modes", default="fast")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if set(modes) - {"fast", "accu"}:
        ap.error(f"--modes {args.modes!r}: fast, accu or fast,accu")
    fastmodes = tuple(mode == "fast" for mode in modes)

    from . import harness

    sizes = tuple(_parse_range(args.sizes))
    moduli = _parse_range(args.moduli) if args.moduli else (
        range(2, 21) if args.dtype == "d" else range(2, 16))
    if args.mode in ("accuracy_check", "all"):
        rows, path = harness.accuracy_check(
            dtype=args.dtype, sizes=sizes, phis=(args.phi,), moduli=moduli,
            outdir=args.outdir, device=args.device)
        print(f"accuracy_check -> {path}")
    # time/watt rows honor an explicit --moduli sweep; default to the
    # headline count per dtype
    time_moduli = tuple(moduli) if args.moduli else (
        (14,) if args.dtype == "d" else (8,))
    if args.mode in ("flops_check", "all"):
        rows, path = harness.time_check(
            dtype=args.dtype, sizes=sizes, num_moduli=time_moduli,
            fastmodes=fastmodes, phi=args.phi, iters=args.iters,
            outdir=args.outdir)
        for row in rows:
            print(row)
        print(f"flops_check -> {path}")
    if args.mode in ("watt_check", "all"):
        rows, _ = harness.watt_check(dtype=args.dtype, sizes=sizes,
                                     num_moduli=time_moduli,
                                     fastmodes=fastmodes, phi=args.phi,
                                     iters=args.iters)
        for row in rows:
            print(row)
        print(f"watt_check -> {len(rows)} rows")


if __name__ == "__main__":
    main()
