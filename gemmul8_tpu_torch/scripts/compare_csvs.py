"""Row-by-row comparison of two accuracy CSVs of the harness's schema.

    python -m gemmul8_tpu_torch.scripts.compare_csvs PORT.csv OTHER.csv

For the (phi, m, k, func) points both files hold: how many rows carry the
same max and median relerr exactly, how many differ, and the largest
ratio between differing max relerrs; the emulated rows (func OS2...) and
the native rows apart. For example the port's card sweep in
`results_torch/` against the JAX package's CPU or TPU sweep in
`results_committed/` (relative errors, not times: a TPU-made CSV may be
compared so).
"""

from __future__ import annotations

import argparse
import csv


def _rows(path: str) -> dict:
    with open(path) as f:
        return {(float(r["phi"]), int(r["m"]), int(r["k"]), r["func"]):
                (float(r["max_relerr"]), float(r["med_relerr"]))
                for r in csv.DictReader(f)}


def compare(port: str, other: str) -> dict:
    """{"emulated"|"native": {"shared", "equal", "worst_ratio", "differ":
    [(point, port row, other row)]}} over the points both CSVs hold."""
    a, b = _rows(port), _rows(other)
    out = {kind: dict(shared=0, equal=0, worst_ratio=1.0, differ=[])
           for kind in ("emulated", "native")}
    for key in sorted(a.keys() & b.keys()):
        part = out["emulated" if key[3].startswith("OS2") else "native"]
        part["shared"] += 1
        if a[key] == b[key]:
            part["equal"] += 1
            continue
        part["differ"].append((key, a[key], b[key]))
        lo, hi = sorted((a[key][0], b[key][0]))
        if lo > 0:
            part["worst_ratio"] = max(part["worst_ratio"], hi / lo)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gemmul8_tpu_torch.scripts.compare_csvs")
    ap.add_argument("port")
    ap.add_argument("other")
    args = ap.parse_args(argv)
    out = compare(args.port, args.other)
    for kind, part in out.items():
        print(f"{kind}: {part['equal']} of {part['shared']} shared (phi, m, "
              f"k, func) rows equal; {len(part['differ'])} differ, max "
              f"relerr ratio at most {part['worst_ratio']:.3g}")
        for key, mine, theirs in part["differ"][:10]:
            print(f"  {key}: {mine} vs {theirs}")
    return out


if __name__ == "__main__":
    main()
