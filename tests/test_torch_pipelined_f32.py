"""The panel/rider pipeline on f32 and mixed operands and f32 output vs the
JAX package, on the same bits.

The plain versions of the riders' f32 forms (CPU tensors:
`hopper.pipelined.matmul_rider_step` with `a_kind` / `out_kind`,
`matmul_bsplit_pair` with `a_kind` / `b_kind`, `reconstruct_into` with
`kind="f32"`) are held to the JAX package's `matmul_rider_step`,
`matmul_bsplit_pair` and `_reconstruct_into` in interpret mode, on every
region each call writes, at 2, 9 and 20 moduli (an f32 source's left-shift
cap reaches 53 bits at 20), with subnormal, zero, -0.0 and inf/NaN lines in
the rows and columns the encode riders read, and random residues whose f32
results overflow. `gemm_core` under GEMMUL8_PIPELINE 1/2/3 on f32 x f32 ->
f32, f64 x f32 -> f64, f32 x f64 -> f32 and f64 x f64 -> f32 calls, fast
and accurate, and `gemm_core_panels` on an f32 call are held to the JAX
functions with use_pallas=True under the same switch; spies show that the
pipeline ran. Inputs come from a numpy seed; the shapes are the smallest
the gates take (the JAX package's tests/test_pipelined.py ones).

Tolerance: bit equality. A shift may differ from the JAX package's by 1
where its pre-floor value lies within 1e-4 of an integer (the f32 norm's
summation order; the f32 log2 in accurate mode, ROADMAP C3); the output is
then held to the exact product instead (1e-12 of |A||B| for f64 output,
2^-20 of it for f32 output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import pipelined as pp
from gemmul8_tpu.types import F64Bits, bits_to_f64, f64_to_bits
from gemmul8_tpu_torch import pipelined as pl
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.core import riders
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.hopper import pipelined as hp

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SWITCHES = ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
            "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE", "GEMMUL8_MXU_CRT",
            "GEMMUL8_FUSED_RECONSTRUCT", "GEMMUL8_RIDER_UNCOND")
SHIFT_RULE_FRAC = 1e-4
NP = {"f64": np.float64, "f32": np.float32}


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    """Every test starts from the switches' defaults, whatever the
    environment says."""
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")


def _phi(m, n, phi, seed, kind="f64"):
    rng = np.random.default_rng(seed)
    x = (rng.random((m, n)) - 0.5) * np.exp(rng.standard_normal((m, n)) * phi)
    return x.astype(NP[kind])


def _special_rows(x, r0, seed):
    """x with special lines in rows r0.. (columns, for a B given
    transposed by the caller): a subnormal-only row, a zero row, -0.0,
    +-inf and NaN, and subnormals inside a normal row, in x's word."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    k = x.shape[1]
    if x.dtype == np.float32:
        x[r0] = rng.integers(1, 1 << 23, k).astype(np.uint32).view(np.float32)
        x[r0 + 4, ::5] = np.uint32(5).view(np.float32)
    else:
        x[r0] = rng.integers(1, 1 << 52, k).astype(np.uint64).view(np.float64)
        x[r0 + 4, ::5] = np.uint64(5).view(np.float64)
    x[r0 + 1] = 0.0
    x[r0 + 2, ::3] = -0.0
    x[r0 + 3, ::7] = np.inf
    x[r0 + 3, 1::7] = -np.inf
    x[r0 + 3, 2::7] = np.nan
    return x


def _jax(x):
    """The JAX package's operand of the same bits: F64Bits or f32."""
    if x.dtype == np.float64:
        return f64_to_bits(x)
    return jnp.asarray(x)


def _words(x):
    """A float tensor or array as its IEEE words (numpy)."""
    x = np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor)
                             else np.asarray(x))
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _jax_rows(leaves, kind):
    """The JAX reconstruct output's words: (hi, lo) uint32 pairs for f64,
    one f32 array for f32."""
    if kind == "f64":
        hi, lo = (np.asarray(x).astype(np.uint64) for x in leaves[:2])
        return (hi << np.uint64(32)) | lo
    leaf = leaves[0] if isinstance(leaves, (tuple, list)) else leaves
    return np.asarray(leaf).view(np.uint32)


def _spy(monkeypatch, module, name):
    """Count the calls of module.name from here on."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


# ---- the riders' plain versions against the JAX kernels -------------------

# (m, k, n), panel_m, bn: 4 panels of 128 rows
M, K, N, PM, BN = 512, 256, 256, 128, 128
PANEL, PREV, NEXT = 2, 1, 3
_STAGES = {}


def _stage(L, a_kind):
    """Shifts, slices and random residues of one (512, 256, 256) call at L
    moduli, A in a_kind's word with special lines in A-panel NEXT (after
    its shifts were taken, so that inf and NaN reach the encode rider
    alone), on both sides; cached per (L, a_kind). The shifts of panel
    PREV's rows are moved by -120, 0, +150 and +190 in turn, so that its
    reconstruct overflows f32, underflows to subnormals and to zero."""
    key = (L, a_kind)
    if key not in _STAGES:
        a = _phi(M, K, 1.0, 31, a_kind)
        b = _phi(K, N, 1.0, 32, "f32")
        sa = np.asarray(pk.fast_sft_pallas(_jax(a), L, axis=1)).copy()
        sb = pk.fast_sft_pallas(_jax(b), L, axis=0)
        a8 = pk.encode_slices_pallas(_jax(a), jnp.asarray(sa), L, axis=1)
        b8 = pk.encode_slices_pallas(_jax(b), sb, L, axis=0)
        sa[PREV * PM:(PREV + 1) * PM, 0] += np.resize(
            np.array([-120, 0, 150, 190], np.int32), PM)
        sa = jnp.asarray(sa)
        src = _special_rows(a, NEXT * PM, L)
        rng = np.random.default_rng(L)
        r = np.stack([rng.integers(0, tables.MODULI[j], (PM, N))
                      for j in range(L)]).astype(np.uint8)
        jax_side = dict(src=_jax(src), sa=sa, sb=sb, a8=a8, b8=b8,
                        r=jnp.asarray(r))
        port = dict(src=torch.from_numpy(src),
                    sa=torch.from_numpy(np.asarray(sa)),
                    sb=torch.from_numpy(np.asarray(sb)),
                    a8=torch.from_numpy(np.asarray(a8)),
                    bt=riders.kmajor(torch.from_numpy(np.asarray(b8))),
                    r=torch.from_numpy(r))
        _STAGES[key] = (jax_side, port)
    return _STAGES[key]


KIND_PAIRS = [("f64", "f32"), ("f32", "f64"), ("f32", "f32")]


@pytest.mark.parametrize("a_kind,out_kind", KIND_PAIRS)
@pytest.mark.parametrize("L", [2, 9, 20])
def test_rider_step_f32_forms_match_jax(L, a_kind, out_kind):
    """Both riders on: the residues, the previous panel's rows in the
    output's word (random residues: f32 results overflow to inf) and the
    next panel's slices from its source's word; into rows of a full-size
    output, the same rows and nothing else."""
    J, t = _stage(L, a_kind)
    jres, jrec, ja8n = pp.matmul_rider_step(
        J["a8"], J["b8"], PANEL, J["r"], PREV, J["sa"], J["sb"], L, PM, BN,
        a_src=J["src"], next_panel=NEXT, a_kind=a_kind, out_kind=out_kind)
    args = (t["a8"], t["bt"], PANEL, t["r"], PREV, t["sa"], t["sb"], L, PM)
    kw = dict(a_src=t["src"], next_panel=NEXT, a_kind=a_kind,
              out_kind=out_kind)
    res, rows, a8n = hp.matmul_rider_step(*args, **kw)
    np.testing.assert_array_equal(np.asarray(jres), res.numpy())
    assert rows.dtype == riders.KINDS[out_kind]
    np.testing.assert_array_equal(_jax_rows(jrec, out_kind), _words(rows))
    if out_kind == "f32" and L >= 9:
        assert bool(torch.isinf(rows).any()), "no f32 overflow exercised"
        sub = (rows != 0) & (rows.abs() < torch.finfo(torch.float32).tiny)
        assert bool(sub.any()), "no f32 subnormal exercised"
    np.testing.assert_array_equal(np.asarray(ja8n), a8n.numpy())
    out = torch.full((M, N), float("nan"), dtype=riders.KINDS[out_kind])
    _, into, _ = hp.matmul_rider_step(*args, out=out, **kw)
    assert into.data_ptr() == out[PREV * PM:].data_ptr()
    np.testing.assert_array_equal(_words(into), _words(rows))
    others = torch.cat([out[:PREV * PM], out[(PREV + 1) * PM:]])
    assert bool(torch.isnan(others).all()), "rows of no rider written"


@pytest.mark.parametrize("L", [2, 9, 20])
def test_reconstruct_into_f32_matches_jax(L):
    """One panel's rows of an f32 output (random residues on the moved
    shifts: overflow to inf and subnormals included), and no other row."""
    J, t = _stage(L, "f32")
    acc = jnp.zeros((M, N), jnp.float32)
    got = pp._reconstruct_into(J["r"], J["sa"], J["sb"], L, acc, None, PREV,
                               PM, kind="f32")
    out = torch.full((M, N), float("nan"), dtype=torch.float32)
    assert hp.reconstruct_into(t["r"], t["sa"], t["sb"], L, out, PREV, PM,
                               "f32") is out
    rows = slice(PREV * PM, (PREV + 1) * PM)
    np.testing.assert_array_equal(_jax_rows(got, "f32")[rows],
                                  _words(out[rows]))
    assert bool(torch.isnan(out[:PREV * PM]).all())
    assert bool(torch.isnan(out[(PREV + 1) * PM:]).all())
    piece = hk.reconstruct(t["r"], t["sa"][rows], t["sb"], L, "f32")
    np.testing.assert_array_equal(_words(piece), _words(out[rows]))
    with pytest.raises(ValueError, match="out"):
        hp.reconstruct_into(t["r"], t["sa"], t["sb"], L, out.double(), PREV,
                            PM, "f32")


# B split: (512, 256, 1024), 2 panels of 256, bn 256
BM_, BK_, BN_N, BPM, BBN = 512, 256, 1024, 256, 256


@pytest.mark.parametrize("L,a_kind,b_kind", [(2, "f64", "f32"),
                                             (9, "f32", "f64"),
                                             (20, "f32", "f32")])
def test_bsplit_pair_f32_forms_match_jax(L, a_kind, b_kind):
    """The residues of both halves, B's slices (its right half encoded by
    the rider from B's word, special columns there) and A-panel 1's slices
    (special rows there)."""
    assert pp.bsplit_applicable(BM_, BN_N, BK_, L, BPM, BBN)
    a = _phi(BM_, BK_, 1.2, 41, a_kind)
    b = _phi(BK_, BN_N, 1.2, 42, b_kind)
    sa = pk.fast_sft_pallas(_jax(a), L, axis=1)
    sb = pk.fast_sft_pallas(_jax(b), L, axis=0)
    a = _special_rows(a, BPM + 8, L)
    b = np.ascontiguousarray(_special_rows(b.T, BN_N // 2 + 8, L).T)
    ja8 = pk.encode_slices_pallas(_jax(a[:BPM]), sa[:BPM], L, axis=1)
    jb8l = pk.encode_slices_pallas(_jax(b), sb, L, axis=0,
                                   col_tiles=(0, (BN_N // 2) // 512))
    jres, jb8, ja8n = pp.matmul_bsplit_pair(
        ja8, jb8l, _jax(b), sa, sb, L, BPM, BBN, a_src=_jax(a),
        a_kind=a_kind, b_kind=b_kind)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tsa = torch.from_numpy(np.asarray(sa))
    tsb = torch.from_numpy(np.asarray(sb))
    tb8l = hk.encode_slices(tb, tsb, L, axis=0,
                            col_tiles=(0, (BN_N // 2) // 512))
    res, bt, a8n = hp.matmul_bsplit_pair(
        torch.from_numpy(np.asarray(ja8)), tb8l, tb, tsa, tsb, L, BPM,
        a_src=ta, a_kind=a_kind, b_kind=b_kind)
    np.testing.assert_array_equal(np.asarray(jres), res.numpy())
    np.testing.assert_array_equal(np.asarray(jb8).transpose(0, 2, 1),
                                  bt.numpy())
    np.testing.assert_array_equal(np.asarray(ja8n), a8n.numpy())


def test_rider_kinds_checked_and_counted():
    """A source or output whose dtype is not its kind's raises on both
    sides; q_max is each source word's (53 for f32 at 20 moduli); the
    launch keys of the forms count apart."""
    L = 3
    a8 = torch.zeros((L, 256, 32), dtype=torch.int8)
    bt = torch.zeros((L, 64, 32), dtype=torch.int8)
    sa = torch.zeros((256, 1), dtype=torch.int32)
    sb = torch.zeros((1, 64), dtype=torch.int32)
    src = torch.zeros((256, 32), dtype=torch.float32)
    for fn in (hp.matmul_rider_step, hp.matmul_rider_step_plain):
        with pytest.raises(ValueError, match="a_src"):
            fn(a8, bt, 0, None, 0, sa, sb, L, 128, a_src=src, next_panel=1)
        with pytest.raises(ValueError, match="out"):
            fn(a8, bt, 0, None, 0, sa, sb, L, 128,
               out=torch.zeros((256, 64), dtype=torch.float64),
               out_kind="f32")
        with pytest.raises(ValueError, match="kind"):
            fn(a8, bt, 0, None, 0, sa, sb, L, 128, a_kind="f16")
    assert hp._q_max(20, torch.zeros((1, 1))) == enc.q_max(20, 24) == 53
    assert hp._q_max(20, torch.zeros((1, 1), dtype=torch.float64)) == 24
    assert hp._q_max(20, None) == 0
    assert build.form("matmul_rider_step", False, False) == \
        "matmul_rider_step"
    assert build.form("matmul_rider_step", True, False) == \
        "matmul_rider_step[f32,f64]"
    assert build.form("matmul_rider_step", False, True) == \
        "matmul_rider_step[f64,f32]"
    assert build.form("reconstruct_into", True) == "reconstruct_into[f32]"


# ---- gemm_core and gemm_core_panels under the switch -----------------------

def _sfts(a, b, L, fastmode):
    """(JAX shifts, the port's shifts, their floor fractions)."""
    ja, jb = _jax(a), _jax(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fastmode:
        j = (pk.fast_sft_pallas(ja, L, axis=1),
             pk.fast_sft_pallas(jb, L, axis=0))
        p = (hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0))
        fr = (enc.sft_floor_frac(enc.fast_stats(ta, 1)[1], a.shape[1], L),
              enc.sft_floor_frac(enc.fast_stats(tb, 0)[1], b.shape[0], L))
    else:
        j = gg.accurate_sfts(ja, jb, L, use_pallas=True)
        p = tg.accurate_sfts(ta, tb, L)
        smax = hm.magmax_matmul(hk.mag7_operand(ta, 1)[0],
                                hk.mag7_operand(tb, 0)[0])
        fr = tuple(enc.accurate_sft_floor_frac(s, L) for s in smax)
    return ([np.asarray(x) for x in j], [x.numpy() for x in p],
            [f.numpy() for f in fr])


def _hold(got, ref, a, b, L, fastmode):
    """got (the port's output) is the JAX package's ref, bit for bit, where
    the shifts agree; else the floor-boundary rule holds and got is held
    to the exact product."""
    ref = bits_to_f64(ref, to_numpy=True) if isinstance(ref, F64Bits) \
        else np.asarray(ref)
    got = got.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    if np.array_equal(_words(ref), _words(got)):
        return
    js, ps, fr = _sfts(a, b, L, fastmode)
    if all(np.array_equal(j, p) for j, p in zip(js, ps)):
        np.testing.assert_array_equal(_words(ref), _words(got))
        return
    for j, p, f in zip(js, ps, fr):
        diff = j != p
        assert np.abs(j[diff].astype(np.int64) - p[diff]).max() <= 1
        assert float(f.reshape(j.shape)[diff].max()) < SHIFT_RULE_FRAC
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    tol = 2.0 ** -20 if got.dtype == np.float32 else 1e-12
    assert np.all(np.abs(got - a64 @ b64) <= tol * (np.abs(a64) @ np.abs(b64))
                  + 1e-300)


# (a word, b word, out_dtype, moduli, GEMMUL8_PIPELINE, fastmode): every
# combination at some level, f32 x f32 -> f32 at every level fast and at 1
# and 3 accurate, a mixed call accurate at 3; level 3 needs n = 1024 (every
# case also runs the port at all three levels against its default)
CORE_CALLS = [
    ("f32", "f32", "f32", 8, "1", True), ("f32", "f32", "f32", 8, "2", True),
    ("f32", "f32", "f32", 8, "3", True), ("f32", "f32", "f32", 8, "1", False),
    ("f32", "f32", "f32", 8, "3", False),
    ("f64", "f32", "f64", 14, "3", True),
    ("f32", "f64", "f32", 9, "2", True), ("f32", "f64", "f32", 9, "3", False),
    ("f64", "f64", "f32", 8, "1", True)]


@pytest.mark.parametrize("ak,bk,out,L,pipe,fastmode", CORE_CALLS)
def test_gemm_core_pipelined_f32_matches_jax(monkeypatch, ak, bk, out, L,
                                             pipe, fastmode):
    """The JAX package's gemm_core(use_pallas=True) under the same switch;
    the stages ran with the call's words (spies), no one-shot kernel did,
    and every level gives the port's default call's bits."""
    mode = int(pipe)
    m, k, n = (512, 128, 1024) if mode == 3 else (512, 128, 128)
    cfg = pl.choose_panels(m, n, k, L, encode_rider=mode >= 2)
    assert cfg is not None
    assert (mode == 3) == pl.bsplit_applicable(m, n, k, L, *cfg)
    a, b = _phi(m, k, 1.0, m + L, ak), _phi(k, n, 1.0, n + L, bk)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    default = tg.gemm_core(ta, tb, L, fastmode, out)
    monkeypatch.setenv("GEMMUL8_PIPELINE", pipe)
    ref = gg.gemm_core(_jax(a), _jax(b), L, fastmode, out, use_pallas=True)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    pairs = _spy(monkeypatch, hp, "matmul_bsplit_pair_plain")
    last = []
    fn = hp.reconstruct_into_plain
    monkeypatch.setattr(hp, "reconstruct_into_plain",
                        lambda *args: last.append(args[-1]) or fn(*args))
    replaced = [_spy(monkeypatch, hm, "matmul_mod_u8_plain"),
                _spy(monkeypatch, hk, "reconstruct_plain")]
    got = tg.gemm_core(ta, tb, L, fastmode, out)
    panels = m // cfg[0]
    assert (len(steps), len(pairs), len(last)) == (
        (panels - 1, 1, 1) if mode == 3 else (panels, 0, 1))
    assert all(kw["a_kind"] == ak and kw["out_kind"] == out for kw in steps)
    assert all(kw["a_kind"] == ak and kw["b_kind"] == bk for kw in pairs)
    assert last == [out]
    assert not any(replaced), "a one-shot kernel ran under the pipeline"
    assert got.dtype == riders.KINDS[out]
    np.testing.assert_array_equal(_words(default), _words(got))
    _hold(got, ref, a, b, L, fastmode)
    for other in "123":
        if other == pipe:   # got, under the same switch, held above
            continue
        monkeypatch.setenv("GEMMUL8_PIPELINE", other)
        np.testing.assert_array_equal(
            _words(tg.gemm_core(ta, tb, L, fastmode, out)), _words(default))


def test_gemm_core_panels_f32_matches_jax(monkeypatch):
    """The column-panel schedule on an f32 call under PIPELINE=1: each
    panel through the rider steps into f32 rows, the one-shot call's bits
    and the JAX package's."""
    m, k, n, L, n_panel = 512, 128, 256, 8, 128
    assert pl.choose_panels(m, n_panel, k, L) is not None
    a, b = _phi(m, k, 1.0, 23, "f32"), _phi(k, n, 1.0, 24, "f32")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "1")
    ref = gg.gemm_core_panels(_jax(a), _jax(b), L, True, "f32",
                              n_panel=n_panel, use_pallas=True)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    got = tg.gemm_core_panels(ta, tb, L, True, "f32", n_panel=n_panel)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert len(steps) == 2 * (n // n_panel)
    assert all(kw["out_kind"] == "f32" and kw["a_kind"] == "f32"
               for kw in steps)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")
    np.testing.assert_array_equal(_words(tg.gemm_core(ta, tb, L, True,
                                                      "f32")), _words(got))
    _hold(got, ref, a, b, L, True)


# a float32 operand or f32 output under the switch, through the front end
@pytest.mark.parametrize("f32_in", ["a", "b", "out"])
@pytest.mark.parametrize("pipe,fastmode", [("1", True), ("3", False)])
def test_f32_under_pipeline_through_gemm(monkeypatch, pipe, fastmode, f32_in):
    """gemm with a float32 operand or f32 output under the switch: the
    stages run (spies) and the bits are the default call's."""
    a = _phi(512, 128, 0.5, 26)
    b = _phi(128, 1024, 0.5, 27)
    kw = {}
    if f32_in == "a":
        a = a.astype(np.float32)
    elif f32_in == "b":
        b = b.astype(np.float32)
    else:
        kw["out_dtype"] = "f32"
    want = gt.gemm(a, b, num_moduli=8, fastmode=fastmode, device="cpu", **kw)
    monkeypatch.setenv("GEMMUL8_PIPELINE", pipe)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    got = gt.gemm(a, b, num_moduli=8, fastmode=fastmode, device="cpu", **kw)
    assert steps, "the pipeline did not run"
    np.testing.assert_array_equal(_words(want), _words(got))
