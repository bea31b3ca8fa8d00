"""The port's side of the golden file `tests/data/torch_golden.npz`.

The file holds the JAX package's shifts and output digests for a few calls
(written by `tests/test_torch_golden.py`, which runs the JAX package); each
entry says how to make its operands and which call it is. This module
makes the operands and the port's (sft_a, sft_b, digest) of an entry on
any device, so that the CPU tests and `chip_smoke.py` on the card hold the
port to the same file without JAX.

An entry's spec: [kind ("real" or "complex"), [m, k, n], num_moduli,
fastmode, phi, [seed_a, seed_b], complex compute type name or None,
GEMMUL8_PIPELINE value, call], where call is a dict of the front end's
arguments: "dtypes" (the operands' words, "f64" or "f32": for a complex
entry complex128 or complex64 parts), "out_dtype" (None for the default),
"alpha", "beta" (c is phi_matrix(m, n, phi, seed_a + 200) where beta !=
0), "ops" (op_a, op_b; an operand under "T" is stored transposed, so op(A)
is (m, k) and op(B) (k, n) whatever the ops) and, optionally, "env": more
of the JAX package's switches the port's call runs under (the golden bits
are then the JAX package's default call's, which every switch must
give).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from .. import api
from ..core import complexgemm as cg
from ..core import encode as enc
from ..core import gemm as tg
from ..hopper import kernels as hk
from ..types import ComputeType
from .matrices import phi_matrix


def load(path) -> tuple[dict, dict]:
    """(specs by name, arrays by key) of a golden file."""
    with np.load(path) as f:
        arrays = {key: f[key] for key in f.files}
    return json.loads(str(arrays["spec"])), arrays


_DTYPE = {"f64": np.float64, "f32": np.float32}
_CDTYPE = {"f64": np.complex128, "f32": np.complex64}


def operands(kind: str, shape, phi: float, seeds, call=None):
    """numpy operands (a, b) of an entry as the call passes them, in its
    dtypes: for a complex entry complex128 or complex64, the Im parts from
    seed + 100; for a real call an operand under op "T" (or "C") stored
    transposed."""
    m, k, n = shape
    a = phi_matrix(m, k, phi, seed=seeds[0])
    b = phi_matrix(k, n, phi, seed=seeds[1])
    if kind == "complex":
        a = a + 1j * phi_matrix(m, k, phi, seed=seeds[0] + 100)
        b = b + 1j * phi_matrix(k, n, phi, seed=seeds[1] + 100)
        return tuple(x.astype(_CDTYPE[dt])
                     for x, dt in zip((a, b), call["dtypes"]))
    out = []
    for x, dt, op in zip((a, b), call["dtypes"], call["ops"]):
        x = x.astype(_DTYPE[dt])
        out.append(x if op == "N" else np.ascontiguousarray(x.T))
    return tuple(out)


def c_operand(shape, phi: float, seeds):
    """The c of an entry whose beta != 0: float64 (m, n)."""
    return phi_matrix(shape[0], shape[2], phi, seed=seeds[0] + 200)


def digest(c: np.ndarray) -> str:
    """SHA-256 of an output's bits: float64 (or float32) words in C order,
    or the Re words then the Im words."""
    c = np.ascontiguousarray(c)
    parts = [c.real, c.imag] if np.iscomplexobj(c) else [c]
    h = hashlib.sha256()
    for p in parts:
        if p.dtype == np.float32:
            words = np.ascontiguousarray(p).view(np.uint32)
        else:
            words = np.ascontiguousarray(p, dtype=np.float64).view(np.uint64)
        h.update(words.tobytes())
    return h.hexdigest()


def port_entry(spec, device="cpu"):
    """(sft_a, sft_b, digest) of an entry from the port on `device`: the
    plain versions for the CPU, the kernels for a card. The switches the
    entry names are set for the call and restored after."""
    kind, shape, L, fastmode, phi, seeds, ct, pipe, call = spec
    a, b = operands(kind, shape, phi, seeds, call)
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    env = {"GEMMUL8_PIPELINE": pipe, **call.get("env", {})}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        if kind == "real":
            # the shifts of op(A) and op(B)
            oa = ta if call["ops"][0] == "N" else ta.t().contiguous()
            ob = tb if call["ops"][1] == "N" else tb.t().contiguous()
            if fastmode:
                sa, sb = hk.fast_sft(oa, L, 1), hk.fast_sft(ob, L, 0)
            else:
                sa, sb = tg.accurate_sfts(oa, ob, L)
            c_in = (torch.from_numpy(c_operand(shape, phi, seeds)).to(device)
                    if call["beta"] != 0.0 else None)
            c = api.gemm(ta, tb, num_moduli=L, fastmode=fastmode,
                         out_dtype=call["out_dtype"], alpha=call["alpha"],
                         beta=call["beta"], c=c_in, op_a=call["ops"][0],
                         op_b=call["ops"][1])
        else:
            ar, ai = cg.canon_complex(ta)
            br, bi = cg.canon_complex(tb)
            if fastmode:
                sa = enc.joint_fast_sft(ar, ai, L, 1, stats=hk.fast_stats)
                sb = enc.joint_fast_sft(br, bi, L, 0, stats=hk.fast_stats)
            else:
                sa, sb = cg.accurate_sfts_complex(ar, ai, br, bi, L)
            c = api.gemm(ta, tb, num_moduli=L, fastmode=fastmode,
                         compute_type=ComputeType[ct],
                         out_dtype=call["out_dtype"])
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return sa.cpu().numpy(), sb.cpu().numpy(), digest(c.cpu().numpy())
