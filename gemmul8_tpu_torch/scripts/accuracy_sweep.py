"""Reference-protocol accuracy sweeps on the card, or on the CPU.

    python -m gemmul8_tpu_torch.scripts.accuracy_sweep [d|f|c|md|mf|all]
        [--device cuda|cpu] [--outdir results_torch]
        [--m M] [--sizes K,...] [--phis PHI,...] [--moduli LO-HI|L,...]

On the card (the default) the protocols of `scripts/accuracy_sweep_tpu.py`
(GEMMul8/testing/test_double.cu:19-23, test_float.cu,
test_float_complex.cu): m = n = 1024, k in 1024..8192, DGEMM phi in {0.5,
1, 2, 3, 4} at moduli 2-20, SGEMM phi in {0, 0.5, 1, 1.5} at 2-19, the
complex big-matrix sweep at k = 1024 and its Karatsuba and classic spots;
`all` runs d, f and c, and the mixed protocols run by name (md, mf: k in
{1024, 8192}, phi in {0.5, 2}). With `--device cpu` the protocols of
`scripts/accuracy_sweep_cpu.py` (its `PROTOCOLS`; `all` runs d, f, md and
mf) on the kernels' plain versions. `--m`, `--sizes`, `--phis` and
`--moduli` replace the protocol's values (a small run). Ground truth is
the dd oracle (`bench/native.py`). The CSVs go to `--outdir`; plot them
with `python scripts/plot_results.py <csv>` where matplotlib is installed.

The DGEMM rows at m = 1024, k = 8192, phi 0.5 are held to
tests/test_scale_bands.py's rule against the reference's GH200 bands
(`REF_FAST`, `REF_ACCU`; BASELINE.md section 3), one line per check; a
failed check exits nonzero after the CSVs are written.
"""

from __future__ import annotations

import argparse
import sys

from ..bench import harness
from ..bench.__main__ import _parse_range
from . import RESULTS_DIR

# the reference's GH200 max relerr at m = n = 1024, k = 8192, phi = 0.5
# (BASELINE.md section 3), by moduli count: tests/test_scale_bands.py
REF_FAST = {8: 1.43e-01, 10: 2.33e-03, 12: 4.95e-06, 13: 2.41e-07,
            14: 3.47e-08, 15: 7.13e-10, 16: 3.92e-11, 18: 3.59e-14,
            20: 1.83e-15}
REF_ACCU = {8: 7.69e-02, 10: 3.51e-04, 12: 9.78e-07, 13: 3.21e-08,
            14: 4.50e-09, 15: 2.16e-10, 16: 1.87e-11, 18: 1.83e-15,
            20: 5.61e-16}
BAND_M, BAND_K, BAND_PHI = 1024, 8192, 0.5

SIZES = (1024, 2048, 4096, 8192)
BOTH = (True, False)

# scripts/accuracy_sweep_tpu.py: (which, harness function, keywords)
CARD_PROTOCOLS = [
    ("d", "accuracy_check", dict(
        dtype="d", sizes=SIZES, phis=(0.5, 1.0, 2.0, 3.0, 4.0),
        moduli=range(2, 21), fastmodes=BOTH, m=1024)),
    ("f", "accuracy_check", dict(
        dtype="f", sizes=SIZES, phis=(0.0, 0.5, 1.0, 1.5),
        moduli=range(2, 20), fastmodes=BOTH, m=1024)),
    # the reference compiles one complex strategy per binary: the full
    # moduli sweep on big-matrix, spot checks on Karatsuba and classic
    ("c", "accuracy_check_complex", dict(
        sizes=(1024,), phis=(0.0, 0.5, 1.0, 1.5), moduli=range(2, 20),
        compute_types=("big",), fastmodes=BOTH, m=1024)),
    ("c", "accuracy_check_complex", dict(
        sizes=(1024,), phis=(0.5,), moduli=(8, 12, 14),
        compute_types=("kara", "classic"), fastmodes=BOTH, m=1024)),
    ("md", "accuracy_check", dict(
        dtype="md", sizes=(1024, 8192), phis=(0.5, 2.0),
        moduli=range(2, 21), fastmodes=BOTH, m=1024)),
    ("mf", "accuracy_check", dict(
        dtype="mf", sizes=(1024, 8192), phis=(0.5, 2.0),
        moduli=range(2, 21), fastmodes=BOTH, m=1024)),
]
CARD_ALL = ("d", "f", "c")

# scripts/accuracy_sweep_cpu.py PROTOCOLS: dtype -> (phis, moduli_hi)
CPU_PROTOCOLS = {
    "d": ((0.5, 2.0), 21),
    "f": ((0.0, 0.5, 1.0, 1.5), 20),
    "md": ((0.5, 2.0), 21),
    "mf": ((0.5, 2.0), 20),
}


def protocols(which: str, device: str):
    """The (which, harness function name, keywords) of the sweep `which`
    on `device`."""
    if device == "cpu":
        return [(dtype, "accuracy_check", dict(
            dtype=dtype, sizes=SIZES, phis=phis, moduli=range(2, hi),
            fastmodes=BOTH, m=1024))
            for dtype, (phis, hi) in CPU_PROTOCOLS.items()
            if which in (dtype, "all")]
    want = CARD_ALL if which == "all" else (which,)
    return [p for p in CARD_PROTOCOLS if p[0] in want]


def band_checks(rows):
    """tests/test_scale_bands.py's rule on the DGEMM rows at m = 1024, k =
    8192, phi 0.5: each max relerr at most max(4 band, 5e-14), each median
    at most max(band, 5e-16), the max monotone in L within 1.5x (down to
    5e-16). Returns [(description, passed)], empty when the rows hold no
    band point."""
    at = {r["func"]: r for r in rows
          if (r["m"], r["k"], r["phi"]) == (BAND_M, BAND_K, BAND_PHI)}
    checks = []
    for tag, bands in (("OS2-fast", REF_FAST), ("OS2-accu", REF_ACCU)):
        got = {}
        for L, band in bands.items():
            row = at.get(f"{tag}-{L}")
            if row is None:
                continue
            mx, med = row["max_relerr"], row["med_relerr"]
            got[L] = mx
            checks.append((
                f"{tag}-{L}: max {mx:.3e} <= {max(4 * band, 5e-14):.3e}, "
                f"median {med:.3e} <= {max(band, 5e-16):.3e} (GH200 band "
                f"{band:.2e})",
                mx <= max(band * 4.0, 5e-14) and med <= max(band, 5e-16)))
        ls = sorted(got)
        for l0, l1 in zip(ls, ls[1:]):
            checks.append((
                f"{tag} monotone {l0} -> {l1}: {got[l1]:.3e} <= "
                f"max(1.5 x {got[l0]:.3e}, 5e-16)",
                got[l1] <= max(got[l0] * 1.5, 5e-16)))
    return checks


def _floats(s: str):
    return tuple(float(x) for x in s.split(","))


def main(argv=None):
    """Run the sweep; returns {"paths": [...], "rows": [...], "bands":
    [(description, passed)]}. Exits 1 if a band check fails."""
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.accuracy_sweep")
    ap.add_argument("which", nargs="?", default="all",
                    choices=["d", "f", "c", "md", "mf", "all"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--outdir", default=RESULTS_DIR)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--sizes", type=_parse_range, default=None)
    ap.add_argument("--phis", type=_floats, default=None)
    ap.add_argument("--moduli", type=_parse_range, default=None)
    args = ap.parse_args(argv)
    if args.device == "cpu" and args.which == "c":
        ap.error("the CPU protocols (accuracy_sweep_cpu.py) have no c sweep")
    if args.device == "cuda":
        from ..bench.timing import require_gpu

        require_gpu()
    overrides = {key: value for key, value in (
        ("m", args.m), ("sizes", args.sizes), ("phis", args.phis),
        ("moduli", args.moduli)) if value is not None}
    out = {"paths": [], "rows": [], "bands": []}
    for which, fn, kw in protocols(args.which, args.device):
        kw = dict(kw, **overrides, outdir=args.outdir, device=args.device)
        rows, path = getattr(harness, fn)(**kw)
        print(f"{which} sweep ({fn}, {args.device}) -> {path} "
              f"({len(rows)} rows)", flush=True)
        out["paths"].append(path)
        if which == "d":
            out["rows"] += rows
    out["bands"] = band_checks(out["rows"])
    for what, ok in out["bands"]:
        print(f"band {'ok' if ok else 'FAILED'}: {what}", flush=True)
    if any(not ok for _, ok in out["bands"]):
        print("accuracy_sweep: a DGEMM row at k 8192, phi 0.5 is outside "
              "tests/test_scale_bands.py's rule", file=sys.stderr)
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
