"""matmul_reconstruct and the deaddep probe on the wgmma tile
(csrc/matmul_reconstruct.cu, csrc/probe_deaddep.cu): what of them the CPU
can hold.

- The build: each source's launch entry (matmul_reconstruct's, matmul_crt's
  and magmax's own, with matmul_mod's values; the probe on matmul_mod's),
  `-Xptxas -v`, the library's name following the flags; the wgmma tile
  included, the deleted mma.sync tile not.
- matmul_reconstruct's scratch: one block an SM (or a tile), L residue
  planes of its 128 x 256 tile; matmul_crt's the same, by its own entry.
  Its shared memory beside matmul_mod's four stages.
- The walk, mirrored from the source: the producer's (tile, modulus,
  k-tile) order is the consumers', every piece once across the grid; the
  reconstruct chunks of every tile taken once by the consumer warps off a
  counter, every in-range element of the output reconstructed once, and
  the residues and the counter never reused early (a simulation of the
  warps and their two barriers a tile under random schedules).
- The probe's 128 x 256 tile as two logical 128 x 128 tiles of
  `deaddep_plain`: their indices, deaddep's seeds (the accumulator
  fragment's registers 0 and 64), the rider words and elements, the
  chain's batches and scratch words, kloop's spread of its chain over the
  k-tiles giving indep's aux.
- The plain route the kernel follows (matmul_mod_u8's plain version, then
  `reconstruct_mxu`) bit-equal to `matmul_reconstruct_plain` and to the
  JAX `matmul_reconstruct_pallas` in interpret mode, f64 and f32 output,
  2 to 20 moduli, on a ragged shape; the JAX references are computed once
  for the module.

The card holds both kernels to their plain versions (chip_smoke.py phases
3s, 3w, 3q).
"""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import megakernel as mk
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import launch
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.probes import deaddep as pdd
from gemmul8_tpu_torch.types import f64_to_words

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REC_SRC = (build.CSRC / "matmul_reconstruct.cu").read_text()
DD_SRC = (build.CSRC / "probe_deaddep.cu").read_text()
WG_SRC = (build.CSRC / "wgmma_s8.cuh").read_text()
SMS = 132
MR = launch.get("matmul_reconstruct", (9, 0))
MOD = launch.get("matmul_mod", (9, 0))
CRT = launch.get("matmul_crt", (9, 0))
MAG = launch.get("magmax", (9, 0))
BM, BN = 128, MR.tile_n


def _const(src, name):
    found = re.search(rf"constexpr int {name} = (\d+);", src)
    assert found, name
    return int(found.group(1))


def cdiv(x, y):
    return -(-x // y)


# rec_tile's chunks of a tile
CHUNKS = BM * BN // _const(REC_SRC, "kRecChunk")
assert "kChunks = kTileElems / kRecChunk;" in REC_SRC


def tile_at(t, m, n, bn, group):
    """wgmma_s8.cuh TileWalk.at with L = 1: (tm, tn) of tile t."""
    tiles_m, tiles_n = cdiv(m, BM), cdiv(n, bn)
    g, w = divmod(t, group * tiles_n)
    rows = min(group, tiles_m - g * group)
    return g * group + w % rows, w // rows


# ---- the build ------------------------------------------------------------

@pytest.mark.parametrize("src,entry", [("matmul_reconstruct.cu", MR),
                                       ("probe_deaddep.cu", MOD),
                                       ("magmax.cu", MAG),
                                       ("matmul_crt.cu", CRT)])
def test_build_flags_of_the_wgmma_sources(src, entry):
    """Each source takes its launch entry's constants and `-Xptxas -v`,
    reads every constant and refuses to build without them; it runs the
    wgmma tile, not the mma.sync tile."""
    text = (build.CSRC / src).read_text()
    assert build.SOURCE_FLAGS[src] == ("-Xptxas", "-v", *entry.defines())
    for flag in entry.defines():
        name = flag[2:].split("=")[0]
        assert f"!defined({name})" in text and f"= {name};" in text
    assert '#include "wgmma_s8.cuh"' in text
    for old in ('"mma_s8.cuh"', '"crt_gemm.cuh"'):
        assert f"#include {old}" not in text


def test_reconstruct_entry_fits_beside_four_stages():
    """matmul_reconstruct's entry holds matmul_mod's values: its digit
    table and chunk counter fit beside the four stages, and the consumer
    warps' limb rows sit in their warpgroup's half of the staging tile."""
    assert (MR.tile_n, MR.raster_group, MR.stages) == (
        MOD.tile_n, MOD.raster_group, MOD.stages)
    # wgmma_s8.cuh smem_bytes + the digit table (832) and counter (16)
    smem = 1024 + MR.stages * (BM + BN) * 128 + BM * BN + 16 * MR.stages
    assert smem + 832 + 16 <= 232448
    # a warp's limb rows: kLimbRows (4 x kCrtTiles) x kZStride (a half
    # chunk's 64 + 4) ints, four warps a warpgroup
    assert 4 * 12 * (64 + 4) * 4 <= BM * BN // 2
    # the probe's scratch passes and recmxu's digits fit the staging tile
    assert 256 * (24 + 1) * 4 <= BM * BN


def test_build_name_follows_the_reconstruct_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    names = []
    for entry in (MR, launch.MatmulModLaunch(256, 2, 8)):
        monkeypatch.setattr(build, "SOURCE_FLAGS", {
            "matmul_reconstruct.cu": ("-Xptxas", "-v", *entry.defines())})
        names.append(build._library(build.sources()))
    assert names[0] != names[1]


def test_the_wgmma_users_and_the_hook():
    """consume's k-tile hook defaults to a no-op and runs between a
    k-tile's commit and its wait; the CRT runs on the tensor-core bodies
    in both CRT-fused GEMMs: matmul_crt now on the wgmma tile too."""
    body = WG_SRC[WG_SRC.index("__device__ __forceinline__ void consume("):]
    body = body[:body.index("\n}\n")]
    assert body.index("wgmma_commit();") < body.index("hook(kt, nk);") < \
        body.index("wgmma_wait<1>();")
    assert "Hook&& hook = Hook{}" in body
    for inc in ('"crt_mma.cuh"', '"crt_tail.cuh"'):
        assert f"#include {inc}" in REC_SRC
    assert '#include "crt.cuh"' not in REC_SRC
    crt_src = (build.CSRC / "matmul_crt.cu").read_text()
    for inc in ('"wgmma_s8.cuh"', '"crt_mma.cuh"'):
        assert f"#include {inc}" in crt_src
    for old in ('"crt_gemm.cuh"', '"mma_s8.cuh"', '"crt.cuh"'):
        assert f"#include {old}" not in crt_src
    assert build._SIGNATURES["gm8_matmul_crt"] == \
        [build._P] * 6 + [build._I] * 7 + [build._P]
    assert build._SIGNATURES["gm8_matmul_reconstruct"] == \
        [build._P] * 8 + [build._I] * 7 + [build._P]
    assert build._SIGNATURES["gm8_probe_deaddep"] == \
        [build._P] * 10 + [build._I] * 4 + [build._P, build._P]


# ---- the scratch ----------------------------------------------------------

@pytest.mark.parametrize("L,m,n,want_blocks", [
    (14, 8192, 8192, 132), (8, 8192, 8192, 132), (20, 1000, 1500, 48),
    (2, 1, 1, 1), (14, 200, 129, 2), (16, 257, 513, 9)])
def test_reconstruct_scratch_sizing(L, m, n, want_blocks):
    nblocks, shape = hm.reconstruct_scratch_shape(L, m, n, BN, SMS)
    assert nblocks == want_blocks == min(SMS, cdiv(m, BM) * cdiv(n, BN))
    assert shape == (nblocks, L, BM * BN)
    if (L, m) == (14, 8192):   # the main path: 61 MB against 0.94 GB
        assert np.prod(shape) == 60_555_264
        assert np.prod(shape) < L * m * n // 15


def test_matmul_crt_scratch_unchanged():
    """matmul_crt's scratch follows matmul_reconstruct's sizing (one block
    an SM or a 128 x 256 tile, its L residue planes) through its own launch
    entry, whose tile is matmul_reconstruct's; the old 128 x 128 tiles at
    two blocks an SM are gone."""
    assert CRT.tile_n == MR.tile_n == BN
    assert not hasattr(hm, "_crt_scratch")
    for L, m, n in ((14, 8192, 8192), (2, 300, 200), (20, 1, 1)):
        nblocks, shape = hm.reconstruct_scratch_shape(L, m, n, CRT.tile_n,
                                                      SMS)
        assert nblocks == min(SMS, cdiv(m, 128) * cdiv(n, 256))
        assert shape == (nblocks, L, 128 * 256)


def test_reconstruct_wrapper_off_cpu_never_takes_the_plain_version(
        monkeypatch):
    monkeypatch.setattr(hm, "matmul_reconstruct_plain",
                        lambda *a, **k: pytest.fail("plain"))
    a8 = torch.zeros((2, 4, 32), dtype=torch.int8)
    b8 = torch.zeros((2, 32, 6), dtype=torch.int8)
    sa = torch.zeros((4, 1), dtype=torch.int32)
    sb = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hm.matmul_reconstruct(a8, b8.to("meta"), sa, sb, 2)
    with pytest.raises(RuntimeError, match="compute capability"):
        launch.get("matmul_reconstruct", (8, 0))


# ---- the walk and the chunks ------------------------------------------------

SHAPES = [(8192, 8192, 14), (1000, 1500, 20), (200, 129, 2), (1, 1, 8),
          (257, 513, 16), (2048, 2048, 14), (300, 200, 8)]


@pytest.mark.parametrize("m,n,L", SHAPES)
def test_walk_takes_every_piece_once(m, n, L):
    """The producer loads (tile, modulus, k-tile) of its block's tiles in
    the order its consumers take them; across the grid every piece of
    every tile once, every tile inside the output."""
    nk = 3
    tiles = cdiv(m, BM) * cdiv(n, BN)
    P = min(SMS, tiles)
    seen = []
    for b in range(P):
        produced = [(tile_at(t, m, n, BN, MR.raster_group), l, kt)
                    for t in range(b, tiles, P)
                    for l in range(L) for kt in range(nk)]
        consumed = []
        for t in range(b, tiles, P):
            for l in range(L):
                consumed += [(tile_at(t, m, n, BN, MR.raster_group), l, kt)
                             for kt in range(nk)]
        assert produced == consumed
        seen += produced
    want = {((tm, tn), l, kt) for tm in range(cdiv(m, BM))
            for tn in range(cdiv(n, BN)) for l in range(L)
            for kt in range(nk)}
    assert len(seen) == len(want) and set(seen) == want


def _chunk_elements(c):
    """(row, col) in the tile of each element a chunk's lanes write:
    rec_tile, two halves of 64, lane idx's element 16 (idx >> 3) + 8 h +
    (idx & 7) of the chunk's 128 columns."""
    per_row = BN // _const(REC_SRC, "kRecChunk")
    row, col0 = c // per_row, (c % per_row) * 128
    return [(row, col0 + 16 * (idx >> 3) + 8 * h + (idx & 7))
            for h in (0, 1) for idx in range(64)]


def _simulate(n_tiles, ktiles, seed):
    """The consumer warps under a random schedule: in tile i each warp
    forms its k-tiles and stores residues, meets the others at the first
    barrier, takes chunks of the tile off the counter until none is left,
    meets them at the second, and thread 0 (warp 0) resets the counter.
    Returns the chunks each tile got, asserting that a chunk is read only
    while its residues are whole and the counter reset only when no warp
    takes from it."""
    rng = random.Random(seed)
    warps = 8
    counter = [0]
    done = {i: [] for i in range(n_tiles)}
    whole = [None]   # the tile whose residues are all stored

    def warp(w):
        for i in range(n_tiles):
            for _ in range(ktiles):
                assert whole[0] != i, "residues stored after the barrier"
                yield "ktile"
            yield "barrier"
            while True:   # rec_tile
                c = counter[0]
                counter[0] += 1
                if c >= CHUNKS:
                    break
                for _ in range(3):   # loads, contraction, tails
                    assert whole[0] == i, "a chunk read while not whole"
                    yield "step"
                done[i].append(c)
            yield "barrier"
            if w == 0:
                counter[0] = 0

    state = {w: warp(w) for w in range(warps)}
    waiting = set()
    barriers = 0
    while state:
        ready = [w for w in state if w not in waiting]
        if not ready:   # every warp at a barrier: release it
            assert len(waiting) == len(state) == warps, "deadlock"
            i, second = divmod(barriers, 2)
            if second:   # every chunk of tile i is reconstructed
                assert len(done[i]) == CHUNKS
                whole[0] = None
            else:
                whole[0] = i
            barriers += 1
            waiting.clear()
            continue
        w = rng.choice(ready)
        try:
            if next(state[w]) == "barrier":
                waiting.add(w)
        except StopIteration:
            del state[w]
    return done


@pytest.mark.parametrize("n_tiles,ktiles", [(1, 3), (3, 5), (5, 40)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consumers_reconstruct_each_chunk_once(n_tiles, ktiles, seed):
    done = _simulate(n_tiles, ktiles, seed)
    for i in range(n_tiles):
        assert sorted(done[i]) == list(range(CHUNKS))


@pytest.mark.parametrize("m,n,L", SHAPES[1:])
def test_chunks_cover_each_output_element_once(m, n, L):
    """Every in-range element of the output from one chunk of one tile;
    chunks wholly outside the output are skipped."""
    chunks = CHUNKS
    assert chunks * 128 == BM * BN
    per_tile = [_chunk_elements(c) for c in range(chunks)]
    flat = sorted(e for els in per_tile for e in els)
    assert flat == [(r, c) for r in range(BM) for c in range(BN)]
    cell = np.array(per_tile)                       # (chunks, 128, 2)
    hits = np.zeros((m, n), np.int64)
    for tm in range(cdiv(m, BM)):
        for tn in range(cdiv(n, BN)):
            rows, cols = tm * BM + cell[..., 0], tn * BN + cell[..., 1]
            # a chunk runs where its row and first column are inside
            live = (rows[:, :1] < m) & (tn * BN + (np.arange(chunks) % 2)
                                        [:, None] * 128 < n)
            keep = live & (cols < n)
            np.add.at(hits, (rows[keep], cols[keep]), 1)
    assert (hits == 1).all()


# ---- the probe's logical tiles ----------------------------------------------

def _frag(v, tid):
    """(row, col) in the 128 x 256 tile of consumer thread tid's
    accumulator register v (wgmma_s8.cuh's CLayout_64xN)."""
    half, lt = divmod(tid, 128)
    warp, lane = divmod(lt, 32)
    v0, v1, v2 = v & 1, (v >> 1) & 1, v >> 2
    return (64 * half + 16 * warp + lane // 4 + 8 * v1,
            8 * v2 + 2 * (lane % 4) + v0)


def test_fragment_registers_split_into_logical_tiles():
    """A thread's registers 64 j .. 64 j + 63 hold columns of logical tile
    j, so its batches 8 j .. 8 j + 7 belong to tile j; every element of
    the wgmma tile is one register of one thread; thread 0's registers 0
    and 64 are the logical tiles' (0, 0)."""
    acc, batch = 128, _const(DD_SRC, "kBatch")
    cells = set()
    for tid in range(256):
        for v in range(acc):
            r, c = _frag(v, tid)
            assert c // pdd.TILE == v // 64 == (v // batch) // 8
            cells.add((r, c))
    assert cells == {(r, c) for r in range(128) for c in range(256)}
    assert _frag(0, 0) == (0, 0) and _frag(64, 0) == (0, 128)


@pytest.mark.parametrize("n,L", [(1024, 2), (2048, 14), (8192, 14)])
def test_logical_tiles_of_the_walk(n, L):
    """The wgmma tiles of the probe's walk (L n/128 x n/256) map onto the
    plain version's logical tiles (l, i, j) -> (l n/128 + i) n/128 + j,
    each once; a tile's rider words and elements are the plain's blocks."""
    side = n // pdd.TILE
    total = L * side * (n // BN)
    seen = []
    for t in range(total):
        l, r = divmod(t, side * (n // BN))
        tm, tn = tile_at(r, n, n, BN, MOD.raster_group)
        tile0 = (l * side + tm) * side + 2 * tn
        seen += [tile0, tile0 + 1]
        # deaddep's seed of logical tile j: the product at (128 tm, 128 (2
        # tn + j)) = corner_products[l, tm, 2 tn + j]
        for j in (0, 1):
            r0, c0 = _frag(64 * j, 0)
            assert (tm * BM + r0, tn * BN + c0) == (
                pdd.TILE * tm, pdd.TILE * (2 * tn + j))
    assert sorted(seen) == list(range(pdd.tiles(n, L)))
    # hbm: logical tile j's words tid + 256 e, e < 8 (one batch a thread),
    # its aux the chained word 0 (the plain's v.reshape(-1, HBM_PER)[:, 0])
    words = sorted(tid + 256 * e for tid in range(256) for e in range(8))
    assert words == list(range(pdd.HBM_PER))
    rec_el = sorted(i for tid in range(256) for i in range(tid, pdd.REC_PER,
                                                           256))
    assert rec_el == list(range(pdd.REC_PER))


def test_scratch_words_of_the_chain():
    """indep / deaddep: a thread's 32 words a pass lie in its warpgroup's
    half of the staging tile, disjoint from every other thread's, and
    cover the half; hbmin parks its two batches in the first 16."""
    half_words = 128 * 256 // 8
    for half in (0, 1):
        words = [half * half_words + bb * 1024 + e * 128 + lt
                 for lt in range(128) for bb in range(4) for e in range(8)]
        assert sorted(words) == list(range(half * half_words,
                                           (half + 1) * half_words))


def _kloop(nk, reps):
    """KLoopChain over nk k-tiles: (units run after each k-tile, first0,
    first1)."""
    batches = 16
    q, rem = divmod(batches * reps, nk)
    v, err, rnd, batch, first = [0] * 8, 0, 0, 0, [0, 0]
    per = []
    for kt in range(nk):
        count = q
        err += rem
        if err >= nk:
            err -= nk
            count += 1
        per.append(count)
        for _ in range(count):
            if rnd == 0:
                v = [0] * 8
            v = [(x * pdd.MUL + pdd.ADD + 2 ** 31) % 2 ** 32 - 2 ** 31
                 for x in v]
            rnd += 1
            if rnd == reps:
                if batch == 0:
                    first[0] = v[0]
                if batch == batches // 2:
                    first[1] = v[0]
                rnd, batch = 0, batch + 1
    return per, first


@pytest.mark.parametrize("n", [1024, 2048, 8192])
@pytest.mark.parametrize("nops", [0, 2, 16, 32])
def test_kloop_spreads_its_chain_and_gives_indeps_aux(n, nops):
    nk = n // 128
    reps = nops // 2
    per, first = _kloop(nk, reps)
    assert sum(per) == 16 * reps and max(per) - min(per) <= 1
    # after k-tile kt, floor((kt + 1) U / nk) units done in all
    assert np.array_equal(np.cumsum(per),
                          [16 * reps * (kt + 1) // nk for kt in range(nk)])
    if nk % 16 == 0 and reps:   # batch b after k-tiles [b nk/16, ...)
        q = nk // 16
        assert all(sum(per[b * q:(b + 1) * q]) == reps for b in range(16))
    want = int(pdd.chain_plain(torch.zeros(1, dtype=torch.int64), reps)[0])
    assert first == [want, want]


# ---- the plain route against the JAX kernel ---------------------------------

RAGGED = (130, 40, 136)       # m, k, n: neither m nor n a multiple of 128
LS = (2, 8, 14, 20)


def _operands(L):
    m, k, n = RAGGED
    rng = np.random.default_rng(70 + L)
    a8 = rng.integers(-128, 128, (L, m, k), dtype=np.int8)
    b8 = rng.integers(-128, 128, (L, k, n), dtype=np.int8)
    sa = rng.integers(-40, 40, (m, 1)).astype(np.int32)
    sb = rng.integers(-40, 40, (1, n)).astype(np.int32)
    return a8, b8, sa, sb


@pytest.fixture(scope="module")
def jax_refs():
    """matmul_reconstruct_pallas in interpret mode, once for the module:
    {(L, out_kind): numpy words} (f64 as (hi, lo) uint32, f32 as uint32)."""
    out = {}
    for L in LS:
        a8, b8, sa, sb = (jnp.asarray(x) for x in _operands(L))
        r64 = mk.matmul_reconstruct_pallas(a8, b8, sa, sb, L, "f64",
                                           block=(128, 128))
        out[(L, "f64")] = (np.asarray(r64.hi), np.asarray(r64.lo))
        r32 = mk.matmul_reconstruct_pallas(a8, b8, sa, sb, L, "f32",
                                           block=(128, 128))
        out[(L, "f32")] = np.asarray(r32).view(np.uint32)
    return out


@pytest.mark.parametrize("out_kind", ["f64", "f32"])
@pytest.mark.parametrize("L", LS)
def test_kernels_route_matches_plain_and_jax(L, out_kind, jax_refs):
    """matmul_mod_u8's plain version, then reconstruct_mxu (the tensor-core
    CRT's plain form): the kernel's route, bit-equal to
    matmul_reconstruct_plain and to the JAX kernel."""
    a8, b8, sa, sb = (torch.from_numpy(x) for x in _operands(L))
    route = rec.reconstruct_mxu(hm.matmul_mod_u8_plain(a8, b8, L), sa, sb, L,
                                out_kind)
    plain = hm.matmul_reconstruct_plain(a8, b8, sa, sb, L, out_kind)
    assert route.dtype == plain.dtype
    view = torch.int64 if out_kind == "f64" else torch.int32
    assert torch.equal(route.view(view), plain.view(view))
    assert torch.equal(hm.matmul_reconstruct(a8, b8, sa, sb, L,
                                             out_kind).view(view),
                       plain.view(view))
    ref = jax_refs[(L, out_kind)]
    if out_kind == "f64":
        hi, lo = f64_to_words(route)
        np.testing.assert_array_equal(ref[0], hi)
        np.testing.assert_array_equal(ref[1], lo)
    else:
        np.testing.assert_array_equal(ref, route.numpy().view(np.uint32))
    assert plain.shape == (RAGGED[0], RAGGED[2])
