"""Matrix-case save and replay: persist a GEMM case to disk, reload it and
re-run any emulation config on it, so that an input found to fail can be
replayed under the harness.

Counterpart of `gemmul8_tpu/bench/replay.py`, with the same `.npz` format
(arrays `a`, `b` and scalar `meta_<name>` entries), so a case saved by
either package replays in the other.
"""

from __future__ import annotations

import numpy as np


def save_case(path: str, a: np.ndarray, b: np.ndarray, **meta) -> None:
    """Persist operands (+ arbitrary scalar metadata) as one .npz."""
    np.savez_compressed(path, a=a, b=b,
                        **{f"meta_{k}": np.asarray(v) for k, v in
                           meta.items()})


def load_case(path: str):
    """-> (a, b, meta dict)."""
    z = np.load(path, allow_pickle=False)
    meta = {k[5:]: z[k][()] for k in z.files if k.startswith("meta_")}
    return z["a"], z["b"], meta


def replay(path: str, num_moduli: int = 14, fastmode: bool = True,
           device="cuda", **gemm_kwargs):
    """Re-run the port's `gemm` on a saved case on `device`; returns (C as
    a numpy array, max_relerr, med_relerr) against the dd oracle."""
    from ..api import gemm
    from .native import dd_gemm, relerr_vs_dd

    a, b, _ = load_case(path)
    c = gemm(a, b, num_moduli=num_moduli, fastmode=fastmode, device=device,
             **gemm_kwargs).cpu().numpy()
    hi, lo = dd_gemm(np.asarray(a, np.float64), np.asarray(b, np.float64))
    mx, med = relerr_vs_dd(c.astype(np.float64), hi, lo)
    return c, mx, med
