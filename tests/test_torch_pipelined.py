"""The panel/rider pipeline and the column-panel schedule vs the JAX
package, on the same bits.

The plain versions of the pipeline's kernels (CPU tensors:
`hopper.pipelined.matmul_rider_step`, `matmul_bsplit_pair`,
`reconstruct_into`, and `encode_slices(col_tiles=)`) are held to the JAX
package's `matmul_rider_step`, `matmul_bsplit_pair`, `_reconstruct_into`
and `encode_slices_pallas(col_tiles=)` in interpret mode, on every region
each call writes. `gemm_core` under GEMMUL8_PIPELINE 1/2/3 and
`gemm_core_panels`, fast and accurate, are held to the JAX functions with
use_pallas=True under the same switch; spies show where the pipeline ran.
The gates are the JAX package's, decision for decision. Inputs come from a
numpy seed; shapes are the JAX tests' small ones, each asserted to pass
its gate.

Tolerance: bit equality. An accurate-mode shift may differ from the JAX
package's by 1 where its floored value lies within f32 rounding of an
integer (the f32 log2; tests/test_torch_accurate.py); the output is then
held to the exact product instead, as tests/test_torch_chunked.py does.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu.bench.matrices import exact_gemm_f64
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import pipelined as pp
from gemmul8_tpu.types import F64Bits, bits_to_f64, f64_to_bits
from gemmul8_tpu_torch import pipelined as pl
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.core import riders
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.hopper import pipelined as hp
from gemmul8_tpu_torch.types import words_to_f64

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SWITCHES = ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
            "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE", "GEMMUL8_MXU_CRT",
            "GEMMUL8_FUSED_RECONSTRUCT", "GEMMUL8_RIDER_UNCOND")


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    """Every test starts from the switches' defaults, whatever the
    environment says."""
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")


def _phi(m, n, phi, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((m, n)) - 0.5) * np.exp(
        rng.standard_normal((m, n)) * phi)


def _spy(monkeypatch, module, name):
    """Count the calls of module.name from here on."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _bits(x):
    return x.contiguous().view(torch.int64)


def _f64(hi, lo):
    """JAX (hi, lo) words -> float64 tensor."""
    return words_to_f64(np.asarray(hi), np.asarray(lo))


_AGREE = {}


def _shifts_agree(a, b, L, fastmode):
    """Whether the port's shifts are the JAX package's (else one lies at a
    floor boundary, and both encodings are valid); cached per operands."""
    key = (a.tobytes(), b.tobytes(), L, fastmode)
    if key not in _AGREE:
        _AGREE[key] = _compare_shifts(a, b, L, fastmode)
    return _AGREE[key]


def _compare_shifts(a, b, L, fastmode):
    A, B = f64_to_bits(a), f64_to_bits(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fastmode:
        ja = pk.fast_sft_pallas(A, L, axis=1)
        jb = pk.fast_sft_pallas(B, L, axis=0)
        sa, sb = hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0)
    else:
        ja, jb = gg.accurate_sfts(A, B, L, use_pallas=True)
        sa, sb = tg.accurate_sfts(ta, tb, L)
    ja, jb = np.asarray(ja), np.asarray(jb)
    assert np.abs(ja.astype(np.int64) - sa.numpy()).max() <= 1
    assert np.abs(jb.astype(np.int64) - sb.numpy()).max() <= 1
    return np.array_equal(ja, sa.numpy()) and np.array_equal(jb, sb.numpy())


def _hold_to_jax(got, ref_bits, a, b, L, fastmode):
    got = got.numpy()
    if _shifts_agree(a, b, L, fastmode):
        np.testing.assert_array_equal(
            bits_to_f64(ref_bits, to_numpy=True).view(np.uint64),
            got.view(np.uint64))
    else:  # a floor-boundary shift: both encodings valid, both accurate
        scale = np.abs(a) @ np.abs(b)
        assert np.all(np.abs(got - exact_gemm_f64(a, b))
                      <= 1e-12 * scale + 1e-300)


# ---- the gates ------------------------------------------------------------

GATE_SHAPES = [(m, n, k) for m in (256, 512, 768, 1024, 2048, 8192, 8200)
               for n in (128, 256, 384, 512, 1024, 4096, 8100, 8192, 16384)
               for k in (100, 128, 256, 1024, 8192, 16384, 16512)]


@pytest.mark.parametrize("L", [2, 5, 8, 9, 11, 14, 17, 20])
def test_gates_match_jax(L):
    """choose_panels, pipeline_applicable, bsplit_applicable and the rider
    tiling decide as the JAX package's, shape for shape."""
    for m, n, k in GATE_SHAPES:
        for enc_rider in (False, True):
            assert pl.choose_panels(m, n, k, L, enc_rider) == \
                pp.choose_panels(m, n, k, L, enc_rider), (m, n, k, enc_rider)
        for pm, bn in itertools.product((128, 256, 512, 1024),
                                        (128, 256, 512)):
            for enc_rider in (False, True):
                assert pl.pipeline_applicable(m, n, k, L, pm, bn, enc_rider) \
                    == pp.pipeline_applicable(m, n, k, L, pm, bn, enc_rider)
            assert pl.bsplit_applicable(m, n, k, L, pm, bn) == \
                pp.bsplit_applicable(m, n, k, L, pm, bn), (m, n, k, pm, bn)


def test_rider_tiles_and_constants_match_jax():
    for pm, np_, steps in itertools.product(
            (128, 256, 320, 1024, 8192), (128, 384, 512, 2048, 8192),
            (1, 5, 10, 56, 112, 224, 4096)):
        assert pl._rider_tiles(pm, np_, steps) == \
            pp._rider_tiles(pm, np_, steps)
    assert pl.ENC_BLOCK == pk.ENC_BLOCK
    # the headline: 8 panels of 1024 rows, bn 512, mode 3 applies
    assert pl.choose_panels(8192, 8192, 8192, 14) == (1024, 512)
    assert pl.choose_panels(8192, 8192, 8192, 14, True) == (1024, 512)
    assert pl.bsplit_applicable(8192, 8192, 8192, 14, 1024, 512)
    assert pl.choose_panels(8192, 4096, 8192, 14) == (1024, 512)


@pytest.mark.parametrize("value", ["", "0", "1", "2", "3", "4", " 2", "x"])
def test_pipeline_mode_matches_jax(monkeypatch, value):
    monkeypatch.setenv("GEMMUL8_PIPELINE", value)
    try:
        want = pp.pipeline_mode()
    except ValueError:
        with pytest.raises(ValueError, match="GEMMUL8_PIPELINE"):
            pl.pipeline_mode()
        return
    assert pl.pipeline_mode() == want


# ---- the kernels' plain versions against the JAX kernels -------------------

# (m, k, n), L, panel_m, bn: 4 panels of 128 rows
M, K, N, L5, PM, BN = 512, 256, 256, 5, 128, 128


@pytest.fixture(scope="module")
def stage_inputs():
    """Slices, residues, sources and shifts of one (512, 256, 256) call at
    5 moduli, on both sides."""
    a, b = _phi(M, K, 1.0, 31), _phi(K, N, 1.0, 32)
    A, B = f64_to_bits(a), f64_to_bits(b)
    sa = pk.fast_sft_pallas(A, L5, axis=1)
    sb = pk.fast_sft_pallas(B, L5, axis=0)
    a8 = pk.encode_slices_pallas(A, sa, L5, axis=1)
    b8 = pk.encode_slices_pallas(B, sb, L5, axis=0)
    rng = np.random.default_rng(33)
    r_prev = np.stack([rng.integers(0, tables.MODULI[j], (PM, N))
                       for j in range(L5)]).astype(np.uint8)
    jax_side = dict(A=A, B=B, sa=sa, sb=sb, a8=a8, b8=b8,
                    r=jnp.asarray(r_prev))
    t = dict(a=torch.from_numpy(a), b=torch.from_numpy(b),
             sa=torch.from_numpy(np.asarray(sa)),
             sb=torch.from_numpy(np.asarray(sb)),
             a8=torch.from_numpy(np.asarray(a8)),
             bt=riders.kmajor(torch.from_numpy(np.asarray(b8))),
             r=torch.from_numpy(r_prev))
    return jax_side, t


@pytest.mark.parametrize("rec,enc", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("a8_kind", ["full", "panel"])
def test_rider_step_matches_jax(stage_inputs, rec, enc, a8_kind):
    """Each rider combination, per-panel output pieces (acc=None): the
    residues, the previous panel's rows and the next panel's slices."""
    J, t = stage_inputs
    panel, prev, nxt = 2, 1, 3
    ja8 = J["a8"] if a8_kind == "full" else \
        J["a8"][:, panel * PM:(panel + 1) * PM]
    ta8 = t["a8"] if a8_kind == "full" else \
        riders.panel_rows(t["a8"], panel, PM).contiguous()
    jres, jrec, ja8n = pp.matmul_rider_step(
        ja8, J["b8"], panel, J["r"] if rec else None, prev, J["sa"], J["sb"],
        L5, PM, BN, a_src=J["A"] if enc else None, next_panel=nxt)
    res, rows, a8n = hp.matmul_rider_step(
        ta8, t["bt"], panel, t["r"] if rec else None, prev, t["sa"],
        t["sb"], L5, PM, a_src=t["a"] if enc else None, next_panel=nxt)
    assert res.dtype == torch.uint8 and tuple(res.shape) == (L5, PM, N)
    np.testing.assert_array_equal(np.asarray(jres), res.numpy())
    assert (rows is None) == (not rec) and (a8n is None) == (not enc)
    if rec:
        assert torch.equal(_bits(_f64(*jrec)), _bits(rows))
    if enc:
        np.testing.assert_array_equal(np.asarray(ja8n), a8n.numpy())


def test_rider_step_full_size_output_matches_jax(stage_inputs):
    """acc="fresh", then the alias chain: each call writes its previous
    panel's rows of the (m, n) output, and those rows are the JAX
    package's."""
    J, t = stage_inputs
    out = torch.full((M, N), float("nan"), dtype=torch.float64)
    jacc = "fresh"
    for panel in (1, 2):
        _, jrec, _ = pp.matmul_rider_step(
            J["a8"], J["b8"], panel, J["r"], panel - 1, J["sa"], J["sb"], L5,
            PM, BN, acc=jacc)
        jacc = jrec
        _, rows, _ = hp.matmul_rider_step(
            t["a8"], t["bt"], panel, t["r"], panel - 1, t["sa"], t["sb"], L5,
            PM, out=out)
        assert rows.data_ptr() == out[(panel - 1) * PM:].data_ptr()
    written = slice(0, 2 * PM)
    assert torch.equal(_bits(_f64(*jacc)[written]), _bits(out[written]))
    assert bool(torch.isnan(out[2 * PM:]).all()), "rows of no rider written"


def test_rider_step_first_stage_copies_b(stage_inputs):
    """With b8 given, the stage first fills the K-major B from it."""
    J, t = stage_inputs
    bt = torch.zeros_like(t["bt"])
    res, _, _ = hp.matmul_rider_step(
        t["a8"], bt, 0, None, -1, t["sa"], t["sb"], L5, PM,
        b8=torch.from_numpy(np.asarray(J["b8"])))
    assert torch.equal(bt, t["bt"])
    jres, _, _ = pp.matmul_rider_step(J["a8"], J["b8"], 0, None, -1, J["sa"],
                                      J["sb"], L5, PM, BN)
    np.testing.assert_array_equal(np.asarray(jres), res.numpy())


def test_reconstruct_into_matches_jax(stage_inputs):
    J, t = stage_inputs
    hi = jnp.zeros((M, N), jnp.uint32)
    got = pp._reconstruct_into(J["r"], J["sa"], J["sb"], L5, hi, hi, 3, PM)
    out = torch.full((M, N), float("nan"), dtype=torch.float64)
    assert hp.reconstruct_into(t["r"], t["sa"], t["sb"], L5, out, 3,
                               PM) is out
    last = slice(3 * PM, 4 * PM)
    assert torch.equal(_bits(_f64(got.hi, got.lo)[last]), _bits(out[last]))
    assert bool(torch.isnan(out[:3 * PM]).all())
    # the plain reconstruct of those residues, into rows of a larger output
    piece = hk.reconstruct(t["r"], t["sa"][last], t["sb"], L5)
    assert torch.equal(_bits(piece), _bits(out[last]))
    into = torch.zeros((2 * PM, N), dtype=torch.float64)
    assert hk.reconstruct(t["r"], t["sa"][last], t["sb"], L5,
                          out=into[PM:]).data_ptr() == into[PM:].data_ptr()
    assert torch.equal(_bits(into[PM:]), _bits(piece))
    with pytest.raises(ValueError, match="out"):
        hk.reconstruct(t["r"], t["sa"][last], t["sb"], L5, out=into)


# B split: (512, 256, 1024), 2 panels of 256, bn 256
BM_, BK_, BN_N, BPM, BBN = 512, 256, 1024, 256, 256


@pytest.mark.parametrize("a_rider", [False, True])
def test_bsplit_pair_matches_jax(a_rider):
    """The residues of both halves, B's slices (the JAX package's (L, k, n)
    buffer transposed: the port keeps B K-major) and A-panel 1's slices."""
    assert pp.bsplit_applicable(BM_, BN_N, BK_, L5, BPM, BBN)
    a, b = _phi(BM_, BK_, 1.2, 41), _phi(BK_, BN_N, 1.2, 42)
    A, B = f64_to_bits(a), f64_to_bits(b)
    sa = pk.fast_sft_pallas(A, L5, axis=1)
    sb = pk.fast_sft_pallas(B, L5, axis=0)
    ja8 = pk.encode_slices_pallas(F64Bits(A.hi[:BPM], A.lo[:BPM]),
                                  sa[:BPM], L5, axis=1)
    jb8l = pk.encode_slices_pallas(B, sb, L5, axis=0,
                                   col_tiles=(0, (BN_N // 2) // 512))
    jres, jb8, ja8n = pp.matmul_bsplit_pair(
        ja8, jb8l, B, sa, sb, L5, BPM, BBN, a_src=A if a_rider else None)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tsa = torch.from_numpy(np.asarray(sa))
    tsb = torch.from_numpy(np.asarray(sb))
    tb8l = hk.encode_slices(tb, tsb, L5, axis=0,
                            col_tiles=(0, (BN_N // 2) // 512))
    res, bt, a8n = hp.matmul_bsplit_pair(
        torch.from_numpy(np.asarray(ja8)), tb8l, tb, tsa, tsb, L5, BPM,
        a_src=ta if a_rider else None)
    np.testing.assert_array_equal(np.asarray(jres), res.numpy())
    np.testing.assert_array_equal(np.asarray(jb8).transpose(0, 2, 1),
                                  bt.numpy())
    assert (a8n is None) == (not a_rider)
    if a_rider:
        np.testing.assert_array_equal(np.asarray(ja8n), a8n.numpy())


@pytest.mark.parametrize("width,tiles", [(1024, (0, 1)), (1024, (1, 2)),
                                         (700, (1, 2)), (1536, (0, 2))])
def test_encode_col_tiles_matches_jax(width, tiles):
    """encode_slices(col_tiles=): the JAX package's columns, in units of
    ENC_BLOCK[1], clipped to the width; the rest is not written."""
    x = _phi(96, width, 1.0, width)
    X = f64_to_bits(x)
    sft = pk.fast_sft_pallas(X, 8, axis=0)
    ref = np.asarray(pk.encode_slices_pallas(X, sft, 8, axis=0,
                                             col_tiles=tiles))
    got = hk.encode_slices(torch.from_numpy(x),
                           torch.from_numpy(np.asarray(sft)), 8, axis=0,
                           col_tiles=tiles)
    c0, c1 = tiles[0] * 512, min(tiles[1] * 512, width)
    assert tuple(got.shape) == (8, 96, width)
    np.testing.assert_array_equal(ref[:, :, c0:c1], got[:, :, c0:c1].numpy())
    full = hk.encode_slices(torch.from_numpy(x),
                            torch.from_numpy(np.asarray(sft)), 8, axis=0)
    assert torch.equal(full[:, :, c0:c1], got[:, :, c0:c1])
    assert not got[:, :, :c0].any() and not got[:, :, c1:].any()


def test_encode_col_tiles_rows():
    """Along A's rows (axis=1) the column range is the same cut."""
    x = torch.from_numpy(_phi(40, 1100, 1.0, 5))
    sft = hk.fast_sft(x, 6, 1)
    got = hk.encode_slices(x, sft, 6, axis=1, col_tiles=(2, 3))
    assert torch.equal(got[:, :, 1024:],
                       hk.encode_slices(x, sft, 6, axis=1)[:, :, 1024:])
    with pytest.raises(ValueError, match="col_tiles"):
        hk.encode_slices(x, sft, 6, axis=1, col_tiles=(3, 4))


# ---- gemm_core and gemm_core_panels under the switch -----------------------

# (m, k, n), L, the switch, fastmode: the JAX tests' small shapes
PIPE_CALLS = [((512, 128, 128), 5, "1", True),
              ((512, 128, 128), 5, "2", True),
              ((512, 128, 1024), 5, "3", True),
              ((512, 128, 128), 5, "1", False),
              ((512, 128, 128), 5, "2", False),
              ((512, 128, 1024), 5, "3", False)]


@pytest.mark.parametrize("shape,L,pipe,fastmode", PIPE_CALLS)
def test_gemm_core_pipelined_matches_jax(monkeypatch, shape, L, pipe,
                                         fastmode):
    m, k, n = shape
    mode = int(pipe)
    cfg = pl.choose_panels(m, n, k, L, encode_rider=mode >= 2)
    assert cfg is not None
    assert (mode == 3) == pl.bsplit_applicable(m, n, k, L, *cfg)
    a, b = _phi(m, k, 1.0, m + L), _phi(k, n, 1.0, n + L)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    default = tg.gemm_core(ta, tb, L, fastmode=fastmode)
    monkeypatch.setenv("GEMMUL8_PIPELINE", pipe)
    # FUSED_RECONSTRUCT gives way to the pipeline, as in the JAX package
    monkeypatch.setenv("GEMMUL8_FUSED_RECONSTRUCT", "1")
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), L, fastmode, "f64",
                       use_pallas=True)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    pairs = _spy(monkeypatch, hp, "matmul_bsplit_pair_plain")
    last = _spy(monkeypatch, hp, "reconstruct_into_plain")
    replaced = [_spy(monkeypatch, hm, "matmul_mod_u8_plain"),
                _spy(monkeypatch, hm, "matmul_reconstruct_plain")]
    got = tg.gemm_core(ta, tb, L, fastmode=fastmode)
    panels = m // cfg[0]
    assert (len(steps), len(pairs), len(last)) == (
        (panels - 1, 1, 1) if mode == 3 else (panels, 0, 1))
    assert not any(replaced), "a one-shot kernel ran under the pipeline"
    assert torch.equal(_bits(default), _bits(got))
    _hold_to_jax(got, ref, a, b, L, fastmode)


@pytest.mark.parametrize("pipe,fastmode", [("0", True), ("1", True),
                                           ("1", False)])
def test_gemm_core_panels_matches_jax(monkeypatch, pipe, fastmode):
    """Both branches of the column-panel schedule (its panels through the
    pipeline or not); fast mode gives the one-shot call's bits, accurate
    mode the JAX package's panel-local shifts (the JAX package's own tests
    hold its accurate panels with and without the pipeline to each
    other)."""
    m, k, n, L, n_panel = 512, 128, 256, 9, 128
    assert pl.choose_panels(m, n_panel, k, L) is not None
    a, b = _phi(m, k, 1.0, 23), _phi(k, n, 1.0, 24)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    monkeypatch.setenv("GEMMUL8_PIPELINE", pipe)
    ref = gg.gemm_core_panels(f64_to_bits(a), f64_to_bits(b), L, fastmode,
                              "f64", n_panel=n_panel, use_pallas=True)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    mm = _spy(monkeypatch, hm, "matmul_mod_u8_plain")
    enc_calls = _spy(monkeypatch, hk, "encode_slices_plain")
    got = tg.gemm_core_panels(ta, tb, L, fastmode, "f64", n_panel=n_panel)
    assert got.dtype == torch.float64 and tuple(got.shape) == (m, n)
    panels = n // n_panel
    assert len(steps) == (2 * panels if pipe == "1" else 0)
    assert len(mm) == (0 if pipe == "1" else panels)
    # A encoded once in fast mode, per panel in accurate mode
    assert len(enc_calls) == (1 if fastmode else panels) + panels
    if fastmode:
        assert torch.equal(_bits(got), _bits(tg.gemm_core(ta, tb, L)))
        _hold_to_jax(got, ref, a, b, L, True)
    else:
        for j0 in range(0, n, n_panel):
            cols = slice(j0, j0 + n_panel)
            ok = _shifts_agree(a, np.ascontiguousarray(b[:, cols]), L, False)
            if ok:
                np.testing.assert_array_equal(
                    bits_to_f64(ref, to_numpy=True)[:, cols].view(np.uint64),
                    got[:, cols].numpy().view(np.uint64))


def test_gemm_n_panel_through_api(monkeypatch):
    """gemm(n_panel=) runs the panel schedule when n_panel < n and the
    one-shot call otherwise; the fast bits are the one-shot call's and the
    JAX package's public gemm's."""
    a, b = _phi(40, 136, 0.5, 3), _phi(136, 70, 0.5, 4)
    one_shot = gt.gemm(a, b, num_moduli=14, device="cpu")
    panels = _spy(monkeypatch, tg, "gemm_core_panels")
    for n_panel in (16, 35, 69):
        got = gt.gemm(a, b, num_moduli=14, n_panel=n_panel, device="cpu")
        assert torch.equal(_bits(got), _bits(one_shot))
    assert len(panels) == 3
    for n_panel in (70, 1000):
        got = gt.gemm(a, b, num_moduli=14, n_panel=n_panel, device="cpu")
        assert torch.equal(_bits(got), _bits(one_shot))
    assert len(panels) == 3
    if _shifts_agree(a, b, 14, True):
        ref = np.asarray(g8.gemm(a, b, num_moduli=14, n_panel=35))
        np.testing.assert_array_equal(ref.view(np.uint64),
                                      one_shot.numpy().view(np.uint64))
    x = torch.ones((4, 4), dtype=torch.float64)
    assert torch.equal(gt.gemm(x, x, n_panel=2),
                       torch.full((4, 4), 4.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="n_panel"):
        gt.gemm(x, x, n_panel=0)
    with pytest.raises(NotImplementedError, match="real path"):
        gt.gemm(x.to(torch.complex128), x, n_panel=2)


# ---- where the pipeline runs, and where it gives way -----------------------

@pytest.mark.parametrize("pipe", ["1", "2", "3"])
@pytest.mark.parametrize("fastmode", [True, False])
def test_pipeline_switch_runs(monkeypatch, pipe, fastmode):
    """Every level of the switch, both modes, through gemm_core and gemm:
    the pipeline's stages run where the gates apply and the bits are the
    default call's; where they do not (4 x 4), the one-shot kernels run."""
    m, k, n, L = 512, 128, 128, 8
    assert pl.choose_panels(m, n, k, L) == (256, 128)
    a = torch.from_numpy(_phi(m, k, 0.5, 51))
    b = torch.from_numpy(_phi(k, n, 0.5, 52))
    want = gt.gemm(a, b, num_moduli=L, fastmode=fastmode)
    monkeypatch.setenv("GEMMUL8_PIPELINE", pipe)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    got = tg.gemm_core(a, b, L, fastmode=fastmode)
    assert torch.equal(_bits(got), _bits(want))
    pub = gt.gemm(a, b, num_moduli=L, fastmode=fastmode)
    assert torch.equal(_bits(pub), _bits(want))
    encode_rider = int(pipe) >= 2
    assert len(steps) == (2 * 2 if pl.choose_panels(
        m, n, k, L, encode_rider) else 0)
    x = torch.ones((4, 4), dtype=torch.float64)
    assert torch.equal(gt.gemm(x, x, fastmode=fastmode),
                       torch.full((4, 4), 4.0, dtype=torch.float64))


@pytest.mark.parametrize("env,kwargs", [
    ({"GEMMUL8_FUSED_ENCODE": "1"}, {}),
    ({}, {"alpha_e": 2}),
    ({}, {"moduli_chunk": 3})])
def test_pipeline_gives_way(monkeypatch, env, kwargs):
    """The pipeline runs only on selected shifts (not under
    GEMMUL8_FUSED_ENCODE=1 in fast mode), with alpha_e == 0 and on the
    one-shot schedule, as in the JAX package."""
    a = torch.from_numpy(_phi(512, 128, 0.5, 53))
    b = torch.from_numpy(_phi(128, 128, 0.5, 54))
    want = tg.gemm_core(a, b, 8, **kwargs)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "3")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    steps = _spy(monkeypatch, hp, "matmul_rider_step_plain")
    got = tg.gemm_core(a, b, 8, **kwargs)
    assert not steps, "the pipeline ran"
    assert torch.equal(_bits(got), _bits(want))


def test_invalid_switch_raises_where_jax_reads_it(monkeypatch):
    """An invalid GEMMUL8_PIPELINE raises on the one-shot schedule (also
    under FUSED_ENCODE, where the pipeline cannot run) and in the panel
    schedule, and is not read by a chunked call or with alpha_e != 0."""
    a = torch.ones((4, 4), dtype=torch.float64)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "4")
    with pytest.raises(ValueError, match="GEMMUL8_PIPELINE"):
        tg.gemm_core(a, a, 14)
    monkeypatch.setenv("GEMMUL8_FUSED_ENCODE", "1")
    with pytest.raises(ValueError, match="GEMMUL8_PIPELINE"):
        tg.gemm_core(a, a, 14)
    with pytest.raises(ValueError, match="GEMMUL8_PIPELINE"):
        tg.gemm_core_panels(a, a, 14, n_panel=2)
    four = torch.full((4, 4), 4.0, dtype=torch.float64)
    assert torch.equal(tg.gemm_core(a, a, 14, moduli_chunk=3), four)
    assert torch.equal(tg.gemm_core(a, a, 14, alpha_e=1), 2 * four)


def test_gemm_pipelined_direct():
    """gemm_pipelined's own arguments: panels smaller than choose_panels
    takes, per-panel pieces (acc_out=False), its fast shifts by default;
    fewer than 2 panels is a ValueError, as in the JAX package."""
    m, k, n, L = 512, 256, 256, 5
    a = torch.from_numpy(_phi(m, k, 1.0, 61))
    b = torch.from_numpy(_phi(k, n, 1.0, 62))
    want = tg.gemm_core(a, b, L)
    for kw in (dict(), dict(encode_rider=True), dict(acc_out=False),
               dict(encode_rider=True, acc_out=False)):
        assert pl.pipeline_applicable(m, n, k, L, 128, 128,
                                      kw.get("encode_rider", False))
        got = pl.gemm_pipelined(a, b, L, panel_m=128, bn=128, **kw)
        assert torch.equal(_bits(got), _bits(want)), kw
    for pm in (256, 512):
        with pytest.raises(ValueError, match="2 panels"):
            pl.gemm_pipelined(a[:256].contiguous(), b, L, panel_m=pm)
    with pytest.raises(ValueError, match="b_rider"):
        pl.gemm_pipelined(a, b, L, panel_m=128, bn=128, b_rider=True)


def test_wrapper_argument_errors():
    L = 3
    a8 = torch.zeros((L, 256, 32), dtype=torch.int8)
    bt = torch.zeros((L, 64, 32), dtype=torch.int8)
    sa = torch.zeros((256, 1), dtype=torch.int32)
    sb = torch.zeros((1, 64), dtype=torch.int32)
    res, rows, nxt = hp.matmul_rider_step(a8, bt, 1, None, 0, sa, sb, L, 128)
    assert tuple(res.shape) == (L, 128, 64) and rows is None and nxt is None
    with pytest.raises(ValueError, match="multiple of 16"):
        hp.matmul_rider_step(a8[:, :, :30], bt[:, :, :30], 0, None, 0, sa,
                             sb, L, 128)
    with pytest.raises(ValueError, match="panel 2"):
        hp.matmul_rider_step(a8, bt, 2, None, 0, sa, sb, L, 128)
    with pytest.raises(ValueError, match="r_prev"):
        hp.matmul_rider_step(a8, bt, 1, res[:, :64], 0, sa, sb, L, 128)
    with pytest.raises(TypeError):
        hp.matmul_rider_step(a8.int(), bt, 0, None, 0, sa, sb, L, 128)
    with pytest.raises(ValueError, match="shifts"):
        hp.matmul_rider_step(a8, bt, 0, None, 0, sa, sb[:, :8], L, 128)
    with pytest.raises(ValueError, match="b_src"):
        hp.matmul_bsplit_pair(a8[:, :128], bt.transpose(1, 2).contiguous(),
                              torch.zeros((32, 8), dtype=torch.float64), sa,
                              sb, L, 128)


# ---- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _card_stage(m=768, k=384, n=512, L=14, pm=256):
    a = torch.from_numpy(_phi(m, k, 1.0, 71)).cuda()
    b = torch.from_numpy(_phi(k, n, 1.0, 72)).cuda()
    sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
    return a, b, sa, sb, hk.encode_slices(a, sa, L, 1), \
        hk.encode_slices(b, sb, L, 0)


@pytest.mark.cuda
def test_rider_step_on_card():
    """Every rider combination, bit-equal to the plain version."""
    _card()
    L, pm = 14, 256
    a, b, sa, sb, a8, b8 = _card_stage()
    bt = torch.empty((L, b.shape[1], a.shape[1]), dtype=torch.int8,
                     device="cuda")
    r0, _, _ = hp.matmul_rider_step(a8, bt, 0, None, -1, sa, sb, L, pm, b8=b8)
    assert torch.equal(bt, riders.kmajor(b8))
    for rec, enc in itertools.product((False, True), repeat=2):
        out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64,
                          device="cuda")
        got = hp.matmul_rider_step(a8, bt, 1, r0 if rec else None, 0, sa, sb,
                                   L, pm, a_src=a if enc else None,
                                   next_panel=2, out=out)
        ref = hp.matmul_rider_step_plain(
            a8, bt, 1, r0 if rec else None, 0, sa, sb, L, pm,
            a_src=a if enc else None, next_panel=2, out=out.clone())
        for x, y in zip(got, ref):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.cuda
def test_bsplit_pair_on_card():
    _card()
    L, pm = 14, 256
    a, b, sa, sb, a8, _ = _card_stage(n=1024)
    b8l = hk.encode_slices(b, sb, L, 0, col_tiles=(0, 1))
    for src in (None, a):
        got = hp.matmul_bsplit_pair(a8[:, :pm].contiguous(), b8l, b, sa, sb,
                                    L, pm, a_src=src)
        ref = hp.matmul_bsplit_pair_plain(a8[:, :pm].contiguous(), b8l, b, sa,
                                          sb, L, pm, a_src=src)
        for x, y in zip(got, ref):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_reconstruct_into_and_col_tiles_on_card():
    _card()
    L, pm = 14, 256
    a, b, sa, sb, a8, b8 = _card_stage()
    r8 = hm.matmul_mod_u8(a8[:, 2 * pm:].contiguous(), b8, L)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64,
                      device="cuda")
    hp.reconstruct_into(r8, sa, sb, L, out, 2, pm)
    ref = hk.reconstruct_plain(r8, sa[2 * pm:], sb, L)
    assert torch.equal(_bits(out[2 * pm:]), _bits(ref))
    assert not out[:2 * pm].any()
    got = hk.encode_slices(b, sb, L, 0, col_tiles=(0, 1))
    assert torch.equal(got[:, :, :512], b8[:, :, :512])


@pytest.mark.cuda
def test_pipelined_calls_on_card(monkeypatch):
    """Each level of the switch and the column panels give the default
    call's bits, with the pipeline's launches."""
    _card()
    from gemmul8_tpu_torch.hopper import build

    a = torch.from_numpy(_phi(512, 256, 1.0, 81)).cuda()
    b = torch.from_numpy(_phi(256, 1024, 1.0, 82)).cuda()
    for fastmode in (True, False):
        ref = gt.gemm(a, b, num_moduli=5, fastmode=fastmode)
        for pipe in "123":
            monkeypatch.setenv("GEMMUL8_PIPELINE", pipe)
            build.LAUNCHES.clear()
            got = gt.gemm(a, b, num_moduli=5, fastmode=fastmode)
            assert build.LAUNCHES["reconstruct_into"] == 1
            assert build.LAUNCHES["matmul_bsplit_pair"] == (
                2 if pipe == "3" else 0)
            assert torch.equal(_bits(got), _bits(ref))
        monkeypatch.setenv("GEMMUL8_PIPELINE", "0")
    got = gt.gemm(a, b, num_moduli=5, n_panel=512)
    assert torch.equal(_bits(got), _bits(gt.gemm(a, b, num_moduli=5)))
