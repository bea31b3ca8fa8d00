"""The fused statistics kernels' arithmetic on the CPU.

`gm8_mag7_fused` (csrc/mag7.cu) reads its operand once: each piece of a
line takes its magnitudes below the running max exponent of what has been
read, and the pieces taken below the line's final max are rewritten as
ceil(m / 2^d). `core.encode.mag7_fused_chunked` is the plain twin of that
arithmetic, with the kernel's two schedules (rows: 8 warps dealt 64-element
f64 or 128-element f32 steps in turn; columns: one reader over 128-row
tiles) and others. It is held bit for bit to the JAX package's
`mag7_fused_pallas` (interpret mode) and to the port's `mag7_fused`, over
lines where the identity could break: the max arriving only in the last
piece, more than 31 (and 63) binades above the pieces before it,
subnormals, +-0 and all-zero lines, infinities and NaN (f32), and a
contraction length no piece width divides. `gm8_fast_encode_fused` takes
the tensor-core encode's weight table, and its source encodes through
encode_mma.cuh, not through remainder chains.

Tolerance: bit equality.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import F64Bits
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.types import f64_to_words

from test_torch_threads import one_torch_thread  # noqa: E402, F401

KDIM = 300          # no piece width below divides it
LINES = 12
# (chunk, ways): the kernel's rows schedules (f64, f32) and columns
# schedule, one reader over short pieces, and pieces wider than a line
SCHEDULES = [(64, 8), (128, 8), (128, 1), (7, 1), (1, 1), (13, 3),
             (2048, 1)]


def _lines(dtype):
    """LINES lines of KDIM elements (rows), one case each."""
    rng = np.random.default_rng(11)
    f64 = dtype == np.float64
    tiny = 5e-324 if f64 else np.float32(1e-45)
    phi = (rng.random((LINES, KDIM)) - 0.5) * np.exp(
        rng.standard_normal((LINES, KDIM)) * 2.0)
    a = phi.astype(dtype)
    a[0] = a[0] * 2.0 ** -40          # the max only in the last element,
    a[0, -1] = 1.5                    # 40 binades above the rest
    a[1] = (rng.integers(1, 1 << 20, KDIM) * tiny).astype(dtype)
    a[2] = 0.0                        # all zero
    a[3, :KDIM // 2] = 0.0            # +-0, then a subnormal, then normals
    a[3, 1:KDIM // 2:3] = -0.0
    a[3, KDIM // 2] = tiny
    a[4, 1:] = a[4, 1:] * (2.0 ** -100 if f64 else 2.0 ** -80)
    a[4, 0] = 3.0                     # the max first; the rest past the clamp
    big = 2.0 ** (200 if f64 else 70)
    a[5, :100] = a[5, :100] / big     # past the clamp, then 31 binades up,
    a[5, 100:299] = a[5, 100:299] * 2.0 ** -31
    a[5, 299] = 1.0                   # then the max in the last element
    a[6] = np.abs(a[6]) * np.exp2(np.arange(KDIM) // 16 * 0.5)  # rising
    a[7] = -np.abs(a[7])
    a[7, ::17] = -0.0
    a[8, :-1] = tiny                  # subnormals, then a normal max last
    a[8, -1] = -2.0
    a[9] = a[9] * 2.0 ** 60
    a[10, 250:] = a[10, 250:] * 2.0 ** 33   # a late rise of 33 binades
    if not f64:
        a[11, 7] = np.inf             # an infinity, then a NaN, late
        a[11, 290] = np.nan
    return a


def _operand(dtype, axis):
    a = _lines(dtype)
    return a if axis == 1 else np.ascontiguousarray(a.T)


@functools.lru_cache(maxsize=None)
def _pallas(dtype_name, axis, shift):
    """mag7_fused_pallas on the operand, as numpy (int8 magnitudes, int32
    emax)."""
    x = _operand(np.dtype(dtype_name).type, axis)
    if x.dtype == np.float64:
        hi, lo = f64_to_words(x)
        arg = F64Bits(jnp.asarray(hi), jnp.asarray(lo))
    else:
        arg = jnp.asarray(x)
    m, e = pk.mag7_fused_pallas(arg, axis, shift)
    return np.asarray(m), np.asarray(e)


@pytest.mark.parametrize("shift", [4, 5])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=[f"c{c}w{w}" for c, w in SCHEDULES])
def test_mag7_fused_chunked_matches_pallas(schedule, dtype, axis, shift):
    chunk, ways = schedule
    x = torch.from_numpy(_operand(np.dtype(dtype).type, axis))
    jm, je = _pallas(dtype, axis, shift)
    m, e = enc.mag7_fused_chunked(x, axis, shift, chunk, ways)
    assert m.dtype == torch.int8 and tuple(m.shape) == x.shape
    assert e.dtype == torch.int32 and tuple(e.shape) == je.shape
    np.testing.assert_array_equal(e.numpy(), je)
    np.testing.assert_array_equal(m.numpy(), jm)
    pm, pe = enc.mag7_fused(x, axis, shift)
    assert torch.equal(m, pm) and torch.equal(e, pe)


def test_lines_cover_the_identity_edges():
    """The lines reach what the identity must survive: a line whose
    running max rises by more than 31 and by 63 or more binades, a max
    that only the last piece holds, subnormal-only and all-zero lines."""
    for dtype in (np.float64, np.float32):
        x = torch.from_numpy(_lines(dtype))
        _, exp, _, nonzero = enc._fields(x)
        e = torch.where(nonzero, exp, 0)
        first, last = e[:, :-1].amax(dim=1), e[:, -1]
        assert int(last[0]) - int(first[0]) > 31
        assert int(e[4, 0]) - int(e[4, 1:].amax()) >= 63
        assert int(e[2].amax()) == 0
        assert int(e[1].amax()) == 1 and int(last[8]) > int(first[8])
        assert bool((e[5, :100].amax() + 63 <= e[5, 299]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_mag7_fused_chunked_random_lines(dtype, chunk):
    """Random lines of a wide exponent spread at both axes, against
    mag7_fused; the rows schedule (8 readers) and the columns one."""
    rng = np.random.default_rng(chunk)
    a = (rng.random((40, 1000)) - 0.5) * np.exp(
        rng.standard_normal((40, 1000)) * 6.0)
    x = torch.from_numpy(a).to(dtype)
    for axis, t in ((1, x), (0, x.t().contiguous())):
        for ways in (1, 8):
            for shift in (4, 5):
                got = enc.mag7_fused_chunked(t, axis, shift, chunk, ways)
                want = enc.mag7_fused(t, axis, shift)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])


def test_fix_byte_is_the_ceiling():
    """The rewrite of a byte m <= 128 taken d binades below the max:
    (m + 2^d - 1) >> d for d < 8, m != 0 from 8 on, is ceil(m / 2^d) for
    every m and d (the kernel's fix_byte)."""
    m = torch.arange(129, dtype=torch.int64).reshape(-1, 1)
    d = torch.arange(1, 80, dtype=torch.int64).reshape(1, -1)
    ds = torch.clamp(d, max=7)
    got = torch.where(d >= 8, (m != 0).to(torch.int64),
                      (m + (1 << ds) - 1) >> ds)
    want = torch.tensor([[-(-mi // 2 ** di) for di in range(1, 80)]
                         for mi in range(129)], dtype=torch.int64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shift", [4, 5])
def test_nested_ceiling_at_every_running_max(dtype, shift):
    """For elements of every exponent, a magnitude taken below any e_run
    between the element's exponent and the line's max, then rewritten by
    d = emax - e_run, is the magnitude taken below emax: the clamp of the
    shift at 63 included."""
    rng = np.random.default_rng(shift)
    mant = 53 if dtype == torch.float64 else 24
    emax_all = 2046 if mant == 53 else 254
    words = rng.integers(0, 1 << 62, 4000, dtype=np.int64)
    if mant == 53:
        x = torch.from_numpy(words.view(np.float64).copy())
    else:
        x = torch.from_numpy((words & 0x7FFFFFFF).astype(np.uint32).view(
            np.float32).copy())
    x = x.reshape(1, -1)
    chunks, exp, _, _ = enc._fields(x)
    for emax in (emax_all, int(exp.median()), 80):
        keep = exp <= emax
        want = enc._extract_mag7(chunks, exp, torch.full_like(exp, emax),
                                 shift).to(torch.int64) & 0xFF
        for lift in (0, 1, 7, 8, 31, 32, 63, 64, 100):
            e_run = torch.clamp(torch.clamp(exp, min=emax - lift), max=emax)
            m = enc._extract_mag7(chunks, exp, e_run, shift).to(
                torch.int64) & 0xFF
            d = emax - e_run
            ds = torch.clamp(d, max=7)
            fixed = torch.where(d >= 8, (m != 0).to(torch.int64),
                                (m + (1 << ds) - 1) >> ds)
            assert torch.equal(fixed[keep], want[keep]), (emax, lift)
            assert int(m[keep].max()) <= 2 ** (shift + 1)


def test_mag7_fused_chunked_argument_errors():
    x = torch.ones((3, 5))
    with pytest.raises(ValueError):
        enc.mag7_fused_chunked(x, 2)
    with pytest.raises(ValueError):
        enc.mag7_fused_chunked(x, 1, chunk=0)
    with pytest.raises(TypeError):
        enc.mag7_fused_chunked(x.half(), 1)


def _c_params(name):
    text = (build.CSRC / {"gm8_fast_encode_fused": "fast_encode_fused.cu",
                          "gm8_mag7_fused": "mag7.cu"}[name]).read_text()
    params = re.search(rf"GM8_EXPORT int {name}\(([^)]*)\)", text).group(1)
    return [p.strip() for p in params.split(",")]


def test_fast_encode_fused_signature_carries_the_table():
    """gm8_fast_encode_fused takes the EncMmaTable as gm8_encode_slices
    does: a host pointer after axis, before num_moduli."""
    params = _c_params("gm8_fast_encode_fused")
    assert params[6] == "const void* table"
    assert params[7] == "int num_moduli"
    assert params[12] == "void* sync"
    sig = build._SIGNATURES["gm8_fast_encode_fused"]
    assert len(sig) == len(params) == 14
    assert sig[6] is build._P and sig[7] is build._I
    assert sig[9] is build._F and sig[12] is build._P   # guard, sync


def test_fast_encode_fused_source_encodes_on_the_tensor_cores():
    """The fused kernel runs encode_mma.cuh's body and the stats bodies of
    fast_stats.cuh; no remainder chain is left in the port's sources."""
    src = (build.CSRC / "fast_encode_fused.cu").read_text()
    assert '#include "encode_mma.cuh"' in src
    assert '#include "fast_stats.cuh"' in src
    assert "contract_reduce" in src and "enc_store16" in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "%" not in re.sub(r'"[^"\n]*"', '""', code)   # asm operands aside
    assert not (build.CSRC / "residue.cuh").exists()
    assert all("residue.cuh" not in p.read_text() for p in build.sources())


def test_mag7_fused_entry_takes_padded_rows():
    """gm8_mag7_fused's buffer rows are 16-byte multiples up to 2^17, what
    the wrapper allocates (ld = k rounded up to 16) for every k the port
    takes."""
    params = _c_params("gm8_mag7_fused")
    assert params[6] == "int ld"
    text = (build.CSRC / "mag7.cu").read_text()
    assert "ld % 16 != 0" in text and "constexpr int kMaxLd = 1 << 17;" in text
    from gemmul8_tpu_torch import tables
    for k in (1, 15, 16, 300, 4100, tables.MAX_K):
        ld = -(-k // 16) * 16
        assert ld % 16 == 0 and k <= ld <= tables.MAX_K
