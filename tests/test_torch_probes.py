"""The probes (clz, op chains, the CRT contraction, integer work inside the
residue GEMM), the CRT-contraction helpers and the timing module against
the JAX package and its probe scripts, on the same bits.

CPU tensors take the kernels' plain versions; the JAX side runs the
scripts' Pallas kernels in interpret mode (`scripts/probe_mxu_crt.py`
`_build(..., interpret=True)`; `scripts/probe_deaddep.py` `build`, which
interprets off the TPU). Inputs come from a numpy seed. Tolerance: bit
equality everywhere.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.bench import timing
from gemmul8_tpu_torch.core import limbs as lb
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.hopper import probes as hp
from gemmul8_tpu_torch.probes import clz as pclz
from gemmul8_tpu_torch.probes import deaddep as pdd
from gemmul8_tpu_torch.probes import mxu_crt as pmxu
from gemmul8_tpu_torch.probes import vpu_ops as pvpu

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import probe_deaddep as jdd  # noqa: E402
import probe_mxu_crt as jmxu  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402, F401


# ---- the CRT-contraction helpers ------------------------------------------

@pytest.mark.parametrize("bm", [8, 16, 32])
@pytest.mark.parametrize("L", range(2, 21))
def test_crt_mxu_consts_match_jax(L, bm):
    wp, cl = rec.crt_mxu_consts(L, bm)
    jwp, jcl = pk._crt_mxu_consts(L, bm)
    assert wp.dtype == jwp.dtype == np.int8
    np.testing.assert_array_equal(wp, jwp)
    assert cl == tuple(jcl)
    wc, cl2 = rec.crt_mxu_weights(L)
    assert cl2 == cl
    np.testing.assert_array_equal(wp[::bm, ::bm], wc)


def _residues(L, bm, bn, seed):
    rng = np.random.default_rng(seed)
    mods = np.asarray(tables.MODULI[:L]).reshape(L, 1, 1)
    return (rng.integers(0, 1 << 30, (L, bm, bn)) % mods).astype(np.uint8)


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("L", [2, 8, 14, 20])
def test_crt_accumulate_mxu_matches_jax(L, bm):
    bn = 256
    r = _residues(L, bm, bn, seed=L * bm)
    wp, cl = rec.crt_mxu_consts(L, bm)
    got = rec.crt_accumulate_mxu(
        rec.centered_residue_block(torch.from_numpy(r), L), wp, L, cl, bm, bn)
    want = pk._crt_accumulate_mxu(
        pk._centered_residues(jnp.asarray(r), L), jnp.asarray(wp), L, cl,
        bm, bn)
    assert len(got) == len(want) == tables.num_limbs(L)
    for g, w in zip(got, want):
        assert all(0 <= v < 2 ** 29 for v in (int(g.min()), int(g.max())))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ref = rec.accumulate_weighted(torch.from_numpy(r).to(torch.int64), L)
    for g, w in zip(lb.carry_propagate(got), ref):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
@pytest.mark.parametrize("L", [2, 14])
def test_centered_residues_match_jax(L, dtype):
    rng = np.random.default_rng(5)
    shape = (L, 8, 128)
    if dtype == "int8":
        c = rng.integers(-128, 128, shape, dtype=np.int8)
    elif dtype == "uint8":
        c = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        c = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int32)
    got = rec.centered_residue_block(torch.from_numpy(c), L)
    want = np.asarray(pk._centered_residues(jnp.asarray(c), L))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


# ---- mxu_crt --------------------------------------------------------------

@pytest.mark.parametrize("bn", [256, 512])
@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("L", [2, 14, 20])
@pytest.mark.parametrize("variant", pmxu.VARIANTS)
def test_mxu_crt_plain_matches_script(variant, L, bm, bn):
    m, n = 64, 512
    r = pmxu.make_input(variant, L, bm, m, n, seed=L + bm)
    wp, nd = jmxu._wp(L, bm)
    want = jmxu._build(L, bm, bn, nd, variant, interpret=True)(
        jnp.asarray(wp), jnp.asarray(r))
    got = hp.mxu_crt(torch.from_numpy(r), L, bm, variant)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mxu_crt_output_does_not_depend_on_bm():
    r = torch.from_numpy(pmxu.make_input("full", 14, 8, 64, 100, seed=2))
    outs = [pmxu.mxu_crt_plain(r, 14, bm) for bm in (1, 8, 16, 64)]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_mxu_crt_rejects_bad_arguments():
    r = torch.zeros((14, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hp.mxu_crt(r, 14, 8, "nope")
    with pytest.raises(TypeError):
        hp.mxu_crt(r.view(torch.int8), 14, 8, "full")
    with pytest.raises(ValueError):
        hp.mxu_crt(r, 13, 8, "full")
    with pytest.raises(ValueError):
        hp.mxu_crt(r.view(torch.int8).reshape(1, 112, 8), 14, 7, "dotonly")


# ---- deaddep --------------------------------------------------------------

def _np_chain(v, reps):
    v = np.asarray(v, dtype=np.int64)
    for _ in range(reps):
        v = ((v * pdd.MUL + pdd.ADD + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    return v.astype(np.int32)


def _gemm_slices(L, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (L, n, n), dtype=np.int8),
            rng.integers(-128, 128, (L, n, n), dtype=np.int8))


@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("variant,nops", [
    ("base", 0), ("indep", 16), ("deaddep", 16), ("hbmin", 16),
    ("hbmio", 16), ("recbody", 0), ("recmxu", 0)])
def test_deaddep_plain_matches_script(variant, nops, L):
    n = 1024
    a8, b8 = _gemm_slices(L, n, seed=L)
    f, (steps, rm, rn) = jdd.build(n, L, nops, variant)
    rng = np.random.default_rng(9)
    rin_j = rin_t = None
    if variant in pdd.HBM:
        rin_j = rng.integers(0, 255, (steps, rm, rn)).astype(np.int32)
        rin_t = torch.from_numpy(rin_j.reshape(-1).copy())
    elif variant in pdd.REC:
        rin_j = rng.integers(0, 199, (steps, L, rm, rn)).astype(np.uint8)
        rin_t = torch.from_numpy(
            rin_j.transpose(1, 0, 2, 3).reshape(L, -1).copy())
    outs = f(jnp.asarray(a8), jnp.asarray(b8),
             None if rin_j is None else jnp.asarray(rin_j))
    res, aux, rout = hp.deaddep(torch.from_numpy(a8), torch.from_numpy(b8),
                                L, nops, variant, rin_t)
    np.testing.assert_array_equal(res.numpy(), np.asarray(outs[0]))
    if variant == "hbmio":
        np.testing.assert_array_equal(rout.numpy(),
                                      np.asarray(outs[2]).reshape(-1))
    if variant in pdd.REC:
        words = rout.view(torch.int64).numpy()
        np.testing.assert_array_equal(
            (words >> 32).astype(np.uint32), np.asarray(outs[2]).reshape(-1))
        np.testing.assert_array_equal(
            (words & 0xFFFFFFFF).astype(np.uint32),
            np.asarray(outs[3]).reshape(-1))
    if variant in pdd.HBM:
        np.testing.assert_array_equal(
            aux.numpy(), _np_chain(rin_j.reshape(-1, pdd.HBM_PER)[:, 0],
                                   nops // 2))


@pytest.mark.parametrize("nops", [0, 2, 16, 32])
@pytest.mark.parametrize("variant", ["indep", "deaddep", "kloop"])
def test_deaddep_chain_matches_recurrence(variant, nops):
    """The JAX probe's scratch is uninitialised, so its aux is not
    comparable: the port's chain is held to a numpy statement of the
    recurrence, seeded 0 (indep; kloop, the port's own variant, which
    interleaves the same chain with the mainloop) or with each tile's
    (0, 0) product & 1."""
    L, n = 2, 1024
    a8, b8 = _gemm_slices(L, n, seed=4)
    _, aux, rout = hp.deaddep(torch.from_numpy(a8), torch.from_numpy(b8), L,
                              nops, variant)
    assert rout is None and aux.shape == (pdd.tiles(n, L),)
    seed = np.zeros(pdd.tiles(n, L), np.int64)
    if variant == "deaddep":
        corner = np.einsum("lik,lkj->lij", a8[:, ::128, :].astype(np.int64),
                           b8[:, :, ::128].astype(np.int64))
        seed = corner.reshape(-1) & 1
        assert 0 < seed.sum() < seed.size
    np.testing.assert_array_equal(aux.numpy(), _np_chain(seed, nops // 2))


def test_deaddep_rejects_bad_arguments():
    a8 = torch.zeros((2, 512, 512), dtype=torch.int8)
    with pytest.raises(ValueError, match="1024"):
        hp.deaddep(a8, a8, 2, 0, "base")
    a8 = torch.zeros((2, 1024, 1024), dtype=torch.int8)
    with pytest.raises(ValueError):
        hp.deaddep(a8, a8, 2, 3, "indep")
    with pytest.raises(ValueError, match="rider"):
        hp.deaddep(a8, a8, 2, 16, "hbmin")
    with pytest.raises(ValueError, match="rider"):
        hp.deaddep(a8, a8, 2, 0, "recbody",
                   torch.zeros((2, 5), dtype=torch.uint8))


def test_deaddep_stamps_only_on_the_card():
    a8 = torch.zeros((2, 1024, 1024), dtype=torch.int8)
    with pytest.raises(ValueError, match="card only"):
        hp.deaddep(a8, a8, 2, 0, "base",
                   stamps=torch.zeros((pdd.tiles(1024, 2), 3),
                                      dtype=torch.int64))
    with pytest.raises(ValueError, match="tiles, 3"):
        hp.deaddep(a8, a8, 2, 0, "base",
                   stamps=torch.zeros((5, 3), dtype=torch.int64))


def test_sm_cycles_is_the_longest_sm_span():
    """Per SM, last end less first start (each SM's clock is its own);
    the most over the SMs, an SM with no block left out."""
    stamps = torch.tensor([[0, 10, 50], [0, 40, 90], [3, 5, 30],
                           [3, 100, 130], [1, 10 ** 12, 10 ** 12 + 7]],
                          dtype=torch.int64)
    assert pdd.sm_cycles(stamps) == 125
    assert pdd.sm_cycles(stamps[:2]) == 80


def test_deaddep_totals_are_the_scripts():
    """Rider elements in all: L (n/1024)(n/512) rm rn, (rm, rn) = (128,
    512) for the hbm variants and (64, 512) or (8, 4096) for the rec ones."""
    n, L = 8192, 14
    steps = L * (n // 1024) * (n // 512)
    assert pdd.tiles(n, L) * pdd.HBM_PER == steps * 128 * 512
    assert pdd.tiles(n, L) * pdd.REC_PER == steps * 64 * 512 == \
        steps * 8 * 4096
    assert pdd.injected_ops(n, L, 16, "indep") == steps * 1024 * 512 * 16


# ---- op chains ------------------------------------------------------------

def _sat_i32(v):
    return jnp.where(v >= 2 ** 31, jnp.int32(2 ** 31 - 1),
                     jnp.where(v < -2 ** 31, jnp.int32(-2 ** 31),
                               v.astype(jnp.int32)))


# the script's lambdas (probe_vpu_ops.py:80-99), restated: `make` is a
# closure inside its `main`; cvt saturates explicitly, as CUDA does
JAX_BODIES = {
    "i32 mul": lambda b, a, i: b * a,
    "i32 constmul": lambda b, a, i: b * np.int32(2 * i + 179),
    "i32 constmac": lambda b, a, i: b * np.int32(2 * i + 179) + a,
    "i32 add": lambda b, a, i: b + a,
    "i32 shr^": lambda b, a, i: (b >> np.int32(1)) ^ a,
    "f32 mul": lambda b, a, i: b * a,
    "f32 constmac": lambda b, a, i: b * np.float32(1.0001)
    + a * np.float32(1e-6),
    "f32 floor": lambda b, a, i: b - jnp.floor(
        b * np.float32(1 / 3)) * np.float32(2.9999),
    "f32->i32 cvt": lambda b, a, i: _sat_i32(
        b.astype(jnp.float32) * np.float32(1.5)) ^ a,
}


@pytest.mark.parametrize("case", pvpu.CASES)
def test_vpu_chain_plain_matches_jnp(case):
    """Each jnp op runs eagerly, so XLA fuses nothing (no FMA)."""
    steps = 3
    x = pvpu.inputs(seed=1)[case][:16, :128]
    a = jnp.asarray(x)
    b = a
    for _ in range(steps):
        for i in range(pvpu.REPS):
            b = JAX_BODIES[case](b, a, i)
    got = hp.vpu_chain(torch.from_numpy(x.copy()), case, steps)
    assert got.dtype == (torch.int32 if case in pvpu.INT_CASES
                         else torch.float32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(b).view(np.uint32))


def test_vpu_cvt_saturates():
    """b * 1.5 leaves int32's range within a few dozen steps: the chain
    must saturate, as cvt.rzi.s32.f32 does."""
    x = np.asarray([[1000, -1000, 7, 0]], np.int32)
    got = pvpu.chain_plain(torch.from_numpy(x), "f32->i32 cvt", 4)
    b = x.astype(np.int64)
    for _ in range(4 * pvpu.REPS):
        v = b.astype(np.float32) * np.float32(1.5)
        b = np.clip(np.trunc(v.astype(np.float64)), -2 ** 31,
                    2 ** 31 - 1).astype(np.int64) ^ x
    np.testing.assert_array_equal(got.numpy(), b.astype(np.int32))
    assert int(got.abs().max()) > 2 ** 30


def test_vpu_chain_rejects_bad_arguments():
    with pytest.raises(ValueError):
        hp.vpu_chain(torch.zeros(4, dtype=torch.int32), "i64 mul")
    with pytest.raises(TypeError):
        hp.vpu_chain(torch.zeros(4, dtype=torch.float32), "i32 add", 1)


# ---- clz ------------------------------------------------------------------

@pytest.mark.parametrize("words", ["edge", "probe", "limbs"])
def test_clz_plain_matches_lax_clz(words):
    x = {"edge": pclz.edge_words(), "probe": pclz.probe_words(),
         "limbs": pclz.limb_words(1 << 16)}[words]
    want = np.asarray(jax.lax.clz(jnp.asarray(x)))
    for form in pclz.FORMS if words == "limbs" else ("clz",):
        got = hp.clz(torch.from_numpy(x), form)
        np.testing.assert_array_equal(got.numpy(), want)


def test_clz_exponent_form_needs_limbs():
    with pytest.raises(ValueError):
        hp.clz(torch.tensor([1 << 24], dtype=torch.int32), "exp")
    with pytest.raises(ValueError):
        hp.clz(torch.tensor([-1], dtype=torch.int32), "exp")
    with pytest.raises(TypeError):
        hp.clz(torch.tensor([1], dtype=torch.int64))


# ---- timing and the entry point -------------------------------------------

def test_require_gpu_exits_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        timing.require_gpu()
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_require_gpu_exits_off_hopper(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "A100")
    with pytest.raises(SystemExit) as e:
        timing.require_gpu()
    assert e.value.code != 0
    assert "sm_90a" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["clz"], ["vpu_ops"], ["mxu_crt"],
                                  ["mxu_crt", "lower"],
                                  ["deaddep", "1024", "2", "16"], []])
def test_probe_entry_point_without_a_card(argv, tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "gemmul8_tpu_torch.probes", *argv],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert ("no CUDA device" if argv else "usage") in out.stderr
    assert out.stdout == ""
    assert not (tmp_path / "build").exists()


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
def test_probe_kernels_on_card():
    """Each probe kernel against its plain version. Skips without a card;
    chip_smoke.py covers more."""
    _card()
    x = torch.from_numpy(pclz.edge_words()).cuda()
    assert torch.equal(hp.clz(x), hp.clz_plain(x))
    for case, v in pvpu.inputs().items():
        v = torch.from_numpy(v[:64]).cuda()
        assert torch.equal(hp.vpu_chain(v, case, 4).cpu(),
                           hp.vpu_chain_plain(v.cpu(), case, 4))
    for variant in pmxu.VARIANTS:
        r = torch.from_numpy(pmxu.make_input(variant, 14, 16, 64, 200)).cuda()
        assert torch.equal(hp.mxu_crt(r, 14, 16, variant),
                           hp.mxu_crt_plain(r, 14, 16, variant))
    a8, b8 = (torch.from_numpy(t).cuda() for t in _gemm_slices(3, 1024, 1))
    for variant in pdd.VARIANTS:
        rin = pdd.make_rider(variant, 1024, 3)
        rin = None if rin is None else torch.from_numpy(rin).cuda()
        nops = 16 if variant in pdd.CHAIN else 0
        stamps = torch.zeros((pdd.tiles(1024, 3), 3), dtype=torch.int64,
                             device="cuda")
        got = hp.deaddep(a8, b8, 3, nops, variant, rin, stamps=stamps)
        want = hp.deaddep_plain(a8, b8, 3, nops, variant, rin)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g.view(-1).view(torch.uint8),
                                   w.view(-1).view(torch.uint8))
        assert pdd.sm_cycles(stamps) > 0


@pytest.mark.cuda
def test_chained_time_on_card():
    _card()
    x = torch.ones(1024, device="cuda")
    sec, out = timing.chained_time(lambda s: s * 2, x, 3)
    assert sec > 0 and float(out[0]) == 16.0
