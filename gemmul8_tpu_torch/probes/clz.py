"""Count leading zeros of int32 words: counterpart of
`scripts/probe_clz.py` (`main`, its Pallas kernel `lax.clz` on a (256, 256)
int32 block).

On the card the probe asks whether `__clz` pays for the most-significant-bit
scan over 16-bit limbs, against the f32-exponent trick it replaced on the
TPU (convert the limb to f32, read the exponent field: exact for words
below 2^24). Both forms are one kernel (`csrc/probe_clz.cu`), timed on 2^26
limb words.
"""

from __future__ import annotations

import numpy as np
import torch

SHAPE = (256, 256)          # probe_clz.py's block
N_TIME = 1 << 26            # words of the timing run
FORMS = ("clz", "exp")      # __clz; the f32-exponent trick (words < 2^24)


def clz_plain(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each int32 word's bit pattern: 32 for 0, 0 for a
    negative word, else 32 - the bit length (frexp's exponent of the exact
    f64 value), as `lax.clz`."""
    if x.dtype != torch.int32:
        raise TypeError("clz takes int32 words")
    _, e = torch.frexp(x.double())
    out = torch.where(x < 0, 0, 32 - e.to(torch.int32))
    return torch.where(x == 0, 32, out).to(torch.int32)


def probe_words(seed: int = 0) -> np.ndarray:
    """The probe's input: (256, 256) int32 in [0, 2^31)."""
    return np.random.default_rng(seed).integers(0, 2 ** 31, SHAPE,
                                                dtype=np.int32)


def edge_words() -> np.ndarray:
    """0, 1, 2^k and 2^k +- 1 for every k, INT_MAX, INT_MIN, -1 and a few
    more negative words."""
    w = {0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2, -2 ** 30}
    for k in range(31):
        w.update((2 ** k - 1, 2 ** k, 2 ** k + 1))
    w = sorted(v for v in w if -2 ** 31 <= v < 2 ** 31)
    return np.asarray(w, dtype=np.int32)


def limb_words(n: int, seed: int = 1) -> np.ndarray:
    """n random 16-bit limbs (every bit length 0..16 equally likely), the
    words the msb scan reads."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 17, n)
    return (rng.integers(0, 2 ** 16, n) >> (16 - bits)).astype(np.int32)


def run(iters: int = 20) -> dict:
    """The probe on the card: the kernel on probe_words against the plain
    version, then both forms timed on N_TIME limb words."""
    from ..bench.timing import chained_time, require_gpu
    from ..hopper import probes as hp

    require_gpu()
    x = torch.from_numpy(probe_words()).cuda()
    ok = torch.equal(hp.clz(x), clz_plain(x))
    print(f"clz kernel builds and launches: True, correct: {ok}",
          flush=True)
    limbs = torch.from_numpy(limb_words(N_TIME)).cuda()
    ref = clz_plain(limbs)
    res = {"correct": ok}
    for form in FORMS:
        got = hp.clz(limbs, form)
        same = torch.equal(got, ref)
        sec, _ = chained_time(lambda _s, f=form: hp.clz(limbs, f), None,
                              iters)
        res[form] = sec * 1e3
        res["correct"] = res["correct"] and same
        print(f"{form:4s} on {N_TIME} limb words: {sec * 1e3:.4f} ms, "
              f"equal to the plain version: {same}", flush=True)
    return res
