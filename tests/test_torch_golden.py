"""Golden bits of the JAX package, for the port on any device.

`tests/data/torch_golden.npz` holds, for a few calls of ragged shapes (real
fast and accurate, complex fast and accurate, pipelined calls on f64, f32
and mixed operands; f32 and mixed operands, f32 output, alpha/beta and op
T; complex64 fast and
accurate and a complex128 x complex64 call; f32 calls under
GEMMUL8_FUSED_ENCODE, GEMMUL8_FUSED_MAG7 and GEMMUL8_FUSED_RECONSTRUCT,
whose golden bits are the JAX package's default call's), how to make the
operands
(shape, phi, seeds of `phi_matrix`, dtypes, ops), the JAX package's shifts
and a SHA-256 digest of the JAX package's output bits
(`gemmul8_tpu_torch.bench.golden` makes the operands and digests). The JAX
side is `gemm_core` / `gemm_complex_core` with use_pallas=True (Pallas in
interpret mode) on the CPU, with the JAX front end's op, dtype, alpha fold
and epilogue around it (`gemmul8_tpu.api`); the alpha/beta entry has f64
output, whose epilogue is the softfloat's separate roundings (the f32 one
is contracted by XLA, ROADMAP C9). Two tests run in Tier-1:

- the file is regenerated from the JAX package and compared with the
  committed one, so it cannot go stale;
- the port's plain path on the CPU gives the same shifts and digests.

`chip_smoke.py` recomputes every entry with the Hopper kernels on the card
and compares, which holds the card to the JAX package without JAX on the
card's host. The entries' seeds are chosen so that no fast-mode shift's
pre-floor value lies within 1e-4 of an integer (`MARGIN`, the repo's
floor-boundary rule), where the f32 norm's summation order on the card
could legally move it by one.

    python tests/test_torch_golden.py    # rewrites tests/data/torch_golden.npz
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import torch  # noqa: E402

from gemmul8_tpu import api as japi  # noqa: E402
from gemmul8_tpu.core import complexgemm as jcg  # noqa: E402
from gemmul8_tpu.core import gemm as gg  # noqa: E402
from gemmul8_tpu.pallas import kernels as pk  # noqa: E402
from gemmul8_tpu.types import F64Bits, bits_to_f64, f64_to_bits  # noqa: E402
from gemmul8_tpu_torch.bench.golden import (c_operand,  # noqa: E402
                                            digest, operands, port_entry)
from gemmul8_tpu_torch.core import encode as enc  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402, F401

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden.npz"
MARGIN = 1e-4



def _call(dtypes=("f64", "f64"), out_dtype=None, alpha=1.0, beta=0.0,
          ops=("N", "N"), env=None):
    call = {"dtypes": list(dtypes), "out_dtype": out_dtype, "alpha": alpha,
            "beta": beta, "ops": list(ops)}
    if env:
        call["env"] = env
    return call


F64 = _call()
F32 = _call(("f32", "f32"))

# name -> (kind, (m, k, n), num_moduli, fastmode, phi, seeds, compute type,
# GEMMUL8_PIPELINE, call)
ENTRIES = {
    "real_fast_ragged": ("real", (72, 200, 56), 14, True, 0.5, (3, 4),
                         None, "0", F64),
    "real_fast_two_chunks": ("real", (24, 2600, 20), 14, True, 1.0, (6, 7),
                             None, "0", F64),
    "real_fast_L8": ("real", (40, 136, 24), 8, True, 2.0, (13, 14), None,
                     "0", F64),
    "real_accurate_ragged": ("real", (72, 200, 56), 14, False, 0.5, (3, 4),
                             None, "0", F64),
    "complex_fast": ("complex", (40, 72, 24), 14, True, 0.5, (21, 22),
                     "COMPLEX_KARATSUBA_MULT", "0", F64),
    "complex_accurate": ("complex", (40, 72, 24), 14, False, 0.5, (21, 22),
                         "COMPLEX_BIG_MATRIX_ENCODE", "0", F64),
    "pipelined_mode3": ("real", (512, 128, 1024), 5, True, 1.0, (41, 42),
                        None, "3", F64),
    "f32_fast_L8": ("real", (72, 200, 56), 8, True, 0.5, (3, 4), None, "0",
                    F32),
    "f32_accurate_L8": ("real", (72, 200, 56), 8, False, 0.5, (3, 4), None,
                        "0", F32),
    "f64_f32_to_f32": ("real", (40, 136, 24), 10, True, 2.0, (13, 14), None,
                       "0", _call(("f64", "f32"), "f32")),
    "f32_f32_to_f64_L10": ("real", (40, 2600, 24), 10, True, 1.0, (6, 7),
                           None, "0", _call(("f32", "f32"), "f64")),
    "alpha_beta_f64": ("real", (48, 96, 40), 14, True, 0.5, (31, 32), None,
                       "0", _call(("f32", "f64"), None, 1.7, -0.3)),
    "op_t_f32": ("real", (56, 120, 32), 8, False, 1.0, (33, 34), None, "0",
                 _call(("f32", "f32"), None, 0.25, 0.0, ("T", "C"))),
    "complex64_fast_L8": ("complex", (40, 72, 24), 8, True, 0.5, (21, 22),
                          "COMPLEX_KARATSUBA_MULT", "0", F32),
    "complex64_accurate_L8": ("complex", (40, 72, 24), 8, False, 0.5,
                              (21, 22), "COMPLEX_BIG_MATRIX_ENCODE", "0",
                              F32),
    "c128_c64_fast": ("complex", (48, 96, 40), 14, True, 0.5, (25, 26),
                      "COMPLEX_CLASSIC_MULT", "0", _call(("f64", "f32"))),
    "f32_fused_encode": ("real", (72, 200, 56), 8, True, 0.5, (3, 4), None,
                         "0", _call(("f32", "f32"),
                                    env={"GEMMUL8_FUSED_ENCODE": "1"})),
    "f32_fused_mag7": ("real", (72, 200, 56), 8, False, 0.5, (3, 4), None,
                       "0", _call(("f32", "f64"), "f32",
                                  env={"GEMMUL8_FUSED_MAG7": "1"})),
    "f32_fused_reconstruct": ("real", (40, 136, 24), 10, True, 2.0,
                              (13, 14), None, "0",
                              _call(("f64", "f32"), "f32",
                                    env={"GEMMUL8_FUSED_RECONSTRUCT": "1"})),
    "f32_pipelined_mode3": ("real", (512, 128, 1024), 8, True, 1.0,
                            (41, 42), None, "3", F32),
    "f64_f32_pipelined_mode2": ("real", (512, 128, 128), 14, True, 1.0,
                                (43, 44), None, "2", _call(("f64", "f32"))),
}


def _jax_part(a):
    """The JAX package's operand of a part's bits: F64Bits or float32."""
    a = np.ascontiguousarray(a)
    return f64_to_bits(a) if a.dtype == np.float64 else jnp.asarray(a)


def _assemble(re, im):
    """A complex numpy array of the JAX core's (re, im) words, bit for
    bit."""
    if isinstance(re, F64Bits):
        re, im = (bits_to_f64(x, to_numpy=True) for x in (re, im))
    re, im = np.asarray(re), np.asarray(im)
    c = np.empty(re.shape, np.complex128 if re.dtype == np.float64
                 else np.complex64)
    c.real, c.imag = re, im
    return c


def jax_entry(name):
    """(sft_a, sft_b, digest) of an entry from the JAX package: its
    Pallas core, inside the JAX front end's op, dtype, alpha fold and
    epilogue for a real call; the default call whatever switches the
    entry's "env" names for the port."""
    kind, shape, L, fastmode, phi, seeds, ct, pipe, call = ENTRIES[name]
    a, b = operands(kind, shape, phi, seeds, call)
    saved = os.environ.get("GEMMUL8_PIPELINE")
    os.environ["GEMMUL8_PIPELINE"] = pipe
    try:
        if kind == "real":
            A = japi._canon_real(japi._apply_op(a, call["ops"][0], False))
            B = japi._canon_real(japi._apply_op(b, call["ops"][1], False))
            out = japi._out_kind(A, B, call["out_dtype"])
            alpha, beta = call["alpha"], call["beta"]
            alpha_e = japi.pow2_exponent(alpha) if beta == 0.0 else None
            if alpha_e is not None:
                alpha = 1.0
            if fastmode:
                sa = pk.fast_sft_pallas(A, L, axis=1)
                sb = pk.fast_sft_pallas(B, L, axis=0)
            else:
                sa, sb = gg.accurate_sfts(A, B, L, use_pallas=True)
            raw = gg.gemm_core(A, B, L, fastmode, out, use_pallas=True,
                               alpha_e=alpha_e or 0)
            c_in = c_operand(shape, phi, seeds) if beta != 0.0 else None
            c = np.asarray(japi._finalize(raw, out, alpha, beta, c_in, True))
        else:
            parts = [_jax_part(x) for x in (a.real, a.imag, b.real, b.imag)]
            if fastmode:
                sa = jcg._joint_sft_pallas(parts[0], parts[1], L, 1)
                sb = jcg._joint_sft_pallas(parts[2], parts[3], L, 0)
            else:
                sa, sb = jcg._accurate_sfts_pallas(*parts, L)
            out = "f64" if "f64" in call["dtypes"] else "f32"
            re, im = jcg.gemm_complex_core(*parts, L, fastmode,
                                           jcg.ComputeType[ct], out,
                                           use_pallas=True)
            c = _assemble(re, im)
    finally:
        if saved is None:
            os.environ.pop("GEMMUL8_PIPELINE", None)
        else:
            os.environ["GEMMUL8_PIPELINE"] = saved
    return (np.asarray(sa, dtype=np.int32), np.asarray(sb, dtype=np.int32),
            digest(c))


def shift_margin(name) -> float:
    """The least distance of a fast-mode shift's pre-floor value from an
    integer over the entry's rows and columns (1.0 in accurate mode, whose
    shifts the card computes with the CPU's ops on exact integers)."""
    kind, shape, L, fastmode, phi, seeds, _, _, call = ENTRIES[name]
    if not fastmode:
        return 1.0
    a, b = operands(kind, shape, phi, seeds, call)
    if kind == "real":   # the shifts are op(A)'s and op(B)'s
        a = a if call["ops"][0] == "N" else np.ascontiguousarray(a.T)
        b = b if call["ops"][1] == "N" else np.ascontiguousarray(b.T)
    worst = 1.0
    for x, axis in ((a, 1), (b, 0)):
        if kind == "real":
            t = torch.from_numpy(x)
            _, nrm2, _ = enc.fast_stats(t, axis)
            frac = enc.sft_floor_frac(nrm2, t.shape[axis], L)
        else:
            re = torch.from_numpy(np.ascontiguousarray(x.real))
            im = torch.from_numpy(np.ascontiguousarray(x.imag))
            _, nrm2, _ = enc.merge_stats(enc.fast_stats(re, axis),
                                         enc.fast_stats(im, axis))
            frac = enc.sft_floor_frac(nrm2, 2 * re.shape[axis], L)
        worst = min(worst, float(frac.min()))
    return worst


def generate(names=None):
    """The golden arrays: per entry its spec, the JAX shifts and digest."""
    out = {"spec": np.asarray(json.dumps(ENTRIES, sort_keys=True))}
    for name in names or ENTRIES:
        sa, sb, dg = jax_entry(name)
        out[f"{name}.sft_a"] = sa
        out[f"{name}.sft_b"] = sb
        out[f"{name}.digest"] = np.asarray(dg)
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {key: f[key] for key in f.files}


def test_golden_spec_is_this_file(golden):
    """The committed file describes these entries, each with a margin."""
    spec = json.loads(str(golden["spec"]))
    assert spec == json.loads(json.dumps(ENTRIES))
    assert GOLDEN.stat().st_size < 1 << 20
    for name in ENTRIES:
        assert shift_margin(name) > MARGIN, name


@pytest.fixture(scope="module")
def jax_entries():
    """jax_entry's results for the module, keyed by what the JAX side
    computes: an entry whose "env" names a port switch has the JAX default
    call of the same operands, so it shares that entry's result."""
    cache = {}

    def get(name):
        kind, shape, L, fastmode, phi, seeds, ct, pipe, call = ENTRIES[name]
        key = json.dumps([kind, shape, L, fastmode, phi, seeds, ct, pipe,
                          {k: v for k, v in call.items() if k != "env"}])
        if key not in cache:
            cache[key] = jax_entry(name)
        return cache[key]
    return get


@pytest.mark.parametrize("name", list(ENTRIES))
def test_golden_file_is_fresh(golden, jax_entries, name):
    """Regenerated from the JAX package, the entry is the committed one."""
    sa, sb, dg = jax_entries(name)
    np.testing.assert_array_equal(golden[f"{name}.sft_a"], sa)
    np.testing.assert_array_equal(golden[f"{name}.sft_b"], sb)
    assert str(golden[f"{name}.digest"]) == dg


@pytest.mark.parametrize("name", list(ENTRIES))
def test_port_matches_golden(golden, monkeypatch, name):
    """The port's plain path on the CPU: the JAX package's shifts and bits
    (the one-shot default and, for the pipelined entry, under its switch
    too)."""
    for key in ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
                "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE",
                "GEMMUL8_MXU_CRT", "GEMMUL8_FUSED_RECONSTRUCT"):
        monkeypatch.delenv(key, raising=False)
    sa, sb, dg = port_entry(ENTRIES[name])
    np.testing.assert_array_equal(golden[f"{name}.sft_a"], sa)
    np.testing.assert_array_equal(golden[f"{name}.sft_b"], sb)
    assert str(golden[f"{name}.digest"]) == dg


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    for entry in ENTRIES:
        print(f"{entry}: margin {shift_margin(entry):.3g}", flush=True)
    np.savez_compressed(GOLDEN, **generate())
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
