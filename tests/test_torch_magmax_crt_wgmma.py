"""matmul_crt and the magnitude GEMM on the wgmma tile (csrc/matmul_crt.cu,
csrc/magmax.cu): what of them the CPU can hold.

- matmul_crt's end, at every moduli count 2..20: the limbs the kernel
  forms from the tensor-core digit sums (`crt_mxu_weights`: Y[2l] + 256
  Y[2l+1] + 32896 S + CL[l], each in [0, 2^29)), carried once low to high,
  bit-equal to the JAX `matmul_crt_pallas` (interpret mode) and to
  `sg.matmul_crt`, the last carry 0; the digit table the kernel builds on
  the host from the CrtTable (crt_mma.cuh `crt_mma_table`) mirrored,
  byte-equal to `hk.crt_mma_table`; the kernel's limb stores covering
  each element of a chunk once.
- The magmax epilogue: the row and column folds over the accumulator
  fragment (CLayout_64xN) mirrored from the source, with its shuffles and
  the warps' buffers, against `amax` on random int32 tiles; the per-tile
  maxima of the walk folded as the scratch form's buffers are, and the
  plain route, against `magmax_matmul_pallas` and `magmax_matmul_scratch`
  (interpret mode) at the wgmma edge shapes.
- The scratch form's buffer shapes for the 128 x 256 tile.
- The tensor maps' extent along k: k, not ld (`k_major_map`, which the
  wrapper calls), so bytes past k in a caller's buffer read as zeros.
- The launch entries, the build flags and the deleted mma.sync tile.

Inputs come from numpy seeds; tolerance: bit equality everywhere. The
card holds both kernels to their plain versions (chip_smoke.py phase
3w).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import launch
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

CRT_SRC = (build.CSRC / "matmul_crt.cu").read_text()
MAG_SRC = (build.CSRC / "magmax.cu").read_text()
MMA_SRC = (build.CSRC / "crt_mma.cuh").read_text()
CRT = launch.get("matmul_crt", (9, 0))
MAG = launch.get("magmax", (9, 0))
MOD = launch.get("matmul_mod", (9, 0))
BM, BN = 128, MAG.tile_n
WGMMA_CASES = [(1, 16, 1), (65, 144, 257), (200, 4100, 129),
               (1000, 4100, 1500)]


def cdiv(x, y):
    return -(-x // y)


def _slices(L, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (L, m, k), dtype=np.int8),
            rng.integers(-128, 128, (L, k, n), dtype=np.int8))


# ---- matmul_crt: the limbs from the digit sums ------------------------------

def kernel_limbs(a8: torch.Tensor, b8: torch.Tensor, L: int):
    """matmul_crt.cu's route on the CPU: the centred residues (store_tile,
    ^ 0x80), the digit sums Y = wc rc (the mma.sync contraction, exact in
    int64), limb l = Y[2l] + 256 Y[2l+1] + CL[l] (the limb rows) + 32896 S
    (added by each lane), then one carry pass low to high. Returns the
    (nl, m, n) limbs, the redundant limbs before the pass, and the final
    carry."""
    rc = hm.matmul_mod_u8_plain(a8, b8, L, centered=True).numpy()
    wc, cl = rec.crt_mxu_weights(L)
    nl = len(cl)
    y = wc @ rc.reshape(L, -1).astype(np.int64)      # (2 nl + 1, m n)
    s = y[2 * nl]
    redundant = np.stack([y[2 * l] + 256 * y[2 * l + 1] + cl[l] + 32896 * s
                          for l in range(nl)])
    out = np.empty_like(redundant)
    carry = np.zeros_like(s)
    for l in range(nl):
        t = redundant[l] + carry
        out[l] = t & 0xFFFF
        carry = t >> 16
    shape = (nl,) + tuple(rc.shape[1:])
    return out.reshape(shape), redundant, carry


@pytest.mark.parametrize("L", range(2, tables.MAX_MODULI + 1))
def test_limbs_from_digit_sums_match_jax(L):
    """Every moduli count: the kernel's limbs bit-equal to the JAX kernel's
    and to the plain version's; the redundant limbs in [0, 2^29), so the
    int32 carry pass is exact; X < 255 L M fits nl limbs, the last carry
    0."""
    m, k, n = 40, 136, 72           # ragged: no multiple of a tile
    a8, b8 = _slices(L, m, k, n, seed=300 + L)
    ta, tb = torch.from_numpy(a8), torch.from_numpy(b8)
    got, redundant, carry = kernel_limbs(ta, tb, L)
    assert redundant.min() >= 0 and redundant.max() < 1 << 29
    assert (carry == 0).all()
    assert got.shape == (tables.num_limbs(L), m, n)
    ref = np.asarray(pm.matmul_crt_pallas(jnp.asarray(a8), jnp.asarray(b8),
                                          L, block=(128, 128, 128)))
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(sg.matmul_crt(ta, tb, L).numpy(), got)
    np.testing.assert_array_equal(hm.matmul_crt(ta, tb, L).numpy(), got)


def test_limbs_at_the_256_lanes_wrap():
    """k = 2^17 of -128 * -128 in the 256 slice: its int32 sum wraps to
    -2^31, whose residue (x & 255) is the exact product's, 0; the limbs of
    the other slices' all-127 products carried as well."""
    L, k = 3, tables.MAX_K
    a8 = torch.full((L, 2, k), -128, dtype=torch.int8)
    b8 = torch.full((L, k, 3), -128, dtype=torch.int8)
    a8[1:] = 127
    b8[1:] = 127
    wrapped = np.int64(np.int32(np.uint32(1 << 31)))
    assert wrapped & 255 == 0 and (128 * 128 * k) % 256 == 0
    got, _, carry = kernel_limbs(a8, b8, L)
    assert (carry == 0).all()
    np.testing.assert_array_equal(sg.matmul_crt(a8, b8, L).numpy(), got)


def crt_table_fields(L):
    """The CrtTable bytes of L moduli (hk.crt_table_entry) as its fields:
    w (20, 6) and big_m (6,) 32-bit words."""
    blob = np.asarray(hk.crt_table_entry(L))
    words = blob[:(tables.MAX_MODULI + 1) * 6 * 4].view(np.uint32)
    return words[:tables.MAX_MODULI * 6].reshape(tables.MAX_MODULI, 6), \
        words[tables.MAX_MODULI * 6:]


def mirror_crt_mma_table(L):
    """crt_mma.cuh crt_mma_table, line for line, in Python integers: the
    digit table the CRT-fused GEMMs build on the host from the CrtTable
    the call passes, as the bytes of `hk.crt_mma_table`."""
    w, big_m = crt_table_fields(L)
    x, carry = [], 0
    for word in big_m:
        v = int(word) * 255 * L + carry
        x.append(v & 0xFFFFFFFF)
        carry = v >> 32
    x.append(carry)
    bits = 0
    for wi in range(len(x) - 1, -1, -1):
        if bits:
            break
        for b in range(31, -1, -1):
            if (x[wi] >> b) & 1:
                bits = 32 * wi + b + 1
                break
    nl = (bits + 15) // 16
    nd = 2 * nl
    table = np.zeros((24, 32), np.int8)
    cl = [0] * 12
    for d in range(nd):
        total = 0
        for j in range(L):
            limb = (int(w[j][d // 4]) >> (16 * ((d // 2) & 1))) & 0xFFFF
            byte = limb >> 8 if d & 1 else limb & 0xFF
            table[d][j] = byte - 128
            total += byte - 128
        c = 128 * total + 128 * 128 * L
        cl[d // 2] += c << 8 if d & 1 else c
    table[nd, :L] = 1
    tail = np.zeros(16, np.int32)
    tail[:12] = cl
    tail[12] = nd
    return np.concatenate([table.view(np.uint8).ravel(), tail.view(np.uint8)])


@pytest.mark.parametrize("L", range(2, tables.MAX_MODULI + 1))
def test_host_digit_table_equals_crt_mma_table(L):
    assert np.array_equal(mirror_crt_mma_table(L), hk.crt_mma_table(L))


def test_digit_table_builder_is_the_mirrored_one():
    """The builder lives once, in crt_mma.cuh, for both CRT-fused GEMMs,
    with the arithmetic the mirror follows."""
    for src in ("matmul_crt.cu", "matmul_reconstruct.cu"):
        text = (build.CSRC / src).read_text()
        assert "P.W = gm8::crt_mma_table(T, L);" in text
        assert "CrtMmaTable mma_table(" not in text
    for line in ("static_cast<unsigned long long>(T.big_m[w]) * (255ull * L)",
                 "const int nl = (bits + 15) / 16;",
                 "W.w[d][j] = static_cast<signed char>(byte - 128);",
                 "const long long c = 128 * sum + 128 * 128 * L;",
                 "for (int j = 0; j < L; ++j) W.w[W.nd][j] = 1;"):
        assert line in MMA_SRC, line


def _const(src, name):
    found = re.search(rf"constexpr int {name} = (\d+);", src)
    assert found, name
    return int(found.group(1))


def test_limb_stores_cover_each_chunk_element_once():
    """A half chunk's limb plane: piece q = lane % 16 of lanes 0-15 (even
    planes) or 16-31 (odd) stores limb row columns 4q .. 4q + 3 at output
    columns 16 (q / 2) + 8 h + 4 (q % 2) ..; with the limb rows' columns
    (idx: element 16 (idx / 8) + 8 h + idx % 8) every element of the
    chunk gets its own limbs, once per plane, in 32-byte runs."""
    chunk = _const(CRT_SRC, "kRecChunk")
    assert "const int col = col0 + 16 * (q >> 1) + 8 * h + 4 * (q & 1);" \
        in CRT_SRC
    assert "for (int l = lane >> 4; l < nl; l += 2)" in CRT_SRC
    for nl in range(2, 12):
        seen = {}
        for h in (0, 1):
            for lane in range(32):
                q = lane & 15
                for l in range(lane >> 4, nl, 2):
                    for e in range(4):
                        idx = 4 * q + e
                        col = 16 * (q >> 1) + 8 * h + 4 * (q & 1) + e
                        # the limb row's column idx holds this element
                        assert col == 16 * (idx >> 3) + 8 * h + (idx & 7)
                        seen[(l, col)] = seen.get((l, col), 0) + 1
        assert seen == {(l, c): 1 for l in range(nl) for c in range(chunk)}


def test_limb_rows_hold_every_plane_and_s():
    """nl <= 11 limb rows and S's row fit the 12 limb rows; each row starts
    on a 16-byte boundary, as the 16-byte reads of the stores need."""
    rows, stride = 12, _const(CRT_SRC, "kRecChunk") // 2 + 4
    assert "constexpr int kLimbRows = 4 * kCrtTiles;" in CRT_SRC
    assert "constexpr int kZStride = kRecHalf + 4;" in CRT_SRC
    assert max(tables.num_limbs(L) for L in range(2, 21)) + 1 <= rows
    assert (stride * 4) % 16 == 0 and (rows * stride * 4) % 16 == 0
    # the instantiations' limb bounds cover their moduli counts
    assert "if (L <= 14) return launch_kernel<8, false>" in CRT_SRC
    assert max(tables.num_limbs(L) for L in range(2, 15)) <= 8
    assert max(tables.num_limbs(L) for L in range(15, 21)) <= 11


# ---- the magmax epilogue ----------------------------------------------------

def _frag_cells(tid):
    """(row, col) in the 128 x 256 tile of consumer thread tid's 128
    accumulator registers (wgmma_s8.cuh CLayout_64xN)."""
    half, lt = divmod(tid, 128)
    warp, lane = divmod(lt, 32)
    v = np.arange(128)
    v0, v1, v2 = v & 1, (v >> 1) & 1, v >> 2
    return (64 * half + 16 * warp + lane // 4 + 8 * v1,
            8 * v2 + 2 * (lane % 4) + v0)


def _shfl_max(x, mask):
    """max(v, __shfl_xor_sync(v, mask)) over each warp's 32 lanes (axis 1
    of an (8 warps, 32 lanes, ...) array)."""
    return np.maximum(x, x[:, np.arange(32) ^ mask])


def magmax_epilogue(tile):
    """magmax.cu's epilogue on one 128 x 256 tile of products, mirrored:
    (row maxima (128,), column maxima (256,))."""
    acc = np.empty((8, 32, 128), np.int64)    # (warp of 8, lane, register)
    for tid in range(256):
        r, c = _frag_cells(tid)
        acc[tid // 32, tid % 32] = tile[r, c]
    v = np.arange(128).reshape(32, 2, 2)       # [v2][v1][v0]
    rows = np.zeros(128, np.int64)
    for v1 in (0, 1):
        x = acc[:, :, v[:, v1, :].ravel()].max(axis=2).clip(min=0)
        x = _shfl_max(_shfl_max(x, 1), 2)
        for warp in range(8):
            for lane in range(0, 32, 4):       # t == 0
                rows[16 * warp + lane // 4 + 8 * v1] = x[warp, lane]
    mine = np.zeros((8, 256), np.int64)
    for v2 in range(32):
        for v0 in (0, 1):
            x = np.maximum(acc[:, :, 4 * v2 + v0], acc[:, :, 4 * v2 + 2 + v0])
            for mask in (4, 8, 16):
                x = _shfl_max(x, mask)
            for t in range(4):                 # g == 0
                mine[:, 8 * v2 + 2 * t + v0] = x[:, t]
    return rows, mine.max(axis=0).clip(min=0)


def test_epilogue_mirrors_the_source():
    for text in ("v = max(v, max(acc[4 * v2 + 2 * v1], acc[4 * v2 + 2 * v1 "
                 "+ 1]));",
                 "const int row = tm * kBM + 16 * warp + g + 8 * v1;",
                 "int v = max(acc[4 * v2 + v0], acc[4 * v2 + 2 + v0]);",
                 "if (g == 0) mine[8 * v2 + 2 * t + v0] = v;",
                 "v = max(v, all[w * kBN + threadIdx.x]);"):
        assert text in MAG_SRC, text
    for mask in (1, 2, 4, 8, 16):
        assert f"__shfl_xor_sync(0xFFFFFFFFu, v, {mask})" in MAG_SRC


@pytest.mark.parametrize("seed", range(4))
def test_epilogue_reduction_is_amax(seed):
    """Random nonnegative int32 products (up to 2^29) and tiles that are
    mostly zero (rows and columns past m or n): the fragment's folds give
    each row's and column's max."""
    rng = np.random.default_rng(seed)
    tile = rng.integers(0, (1 << 29) + 1, (BM, BN), dtype=np.int64)
    if seed % 2:
        tile[rng.integers(1, BM):] = 0
        tile[:, rng.integers(1, BN):] = 0
    rows, cols = magmax_epilogue(tile)
    np.testing.assert_array_equal(rows, tile.max(axis=1))
    np.testing.assert_array_equal(cols, tile.max(axis=0))


def walk_maxima(prod, scratch):
    """The kernel's walk over 128 x 256 tiles of the (m, n) product, each
    tile's epilogue, then the fold: atomicMax into zeros, or the scratch
    form's buffers (magmax_scratch_shapes) and their amax."""
    m, n = prod.shape
    row_shape, col_shape = hm.magmax_scratch_shapes(m, n, BN)
    tiles_m, tiles_n = cdiv(m, BM), cdiv(n, BN)
    padded = np.zeros((tiles_m * BM, tiles_n * BN), np.int64)
    padded[:m, :n] = prod
    row_part = np.full(row_shape, -1, np.int64)
    col_part = np.full(col_shape, -1, np.int64)
    row_max, col_max = np.zeros(m, np.int64), np.zeros(n, np.int64)
    for tm in range(tiles_m):
        for tn in range(tiles_n):
            rows, cols = magmax_epilogue(
                padded[tm * BM:(tm + 1) * BM, tn * BN:(tn + 1) * BN])
            r = slice(tm * BM, min(m, (tm + 1) * BM))
            c = slice(tn * BN, min(n, (tn + 1) * BN))
            nr, nc = r.stop - r.start, c.stop - c.start
            row_part[r, tn] = rows[:nr]
            col_part[tm, c] = cols[:nc]
            row_max[r] = np.maximum(row_max[r], rows[:nr])
            col_max[c] = np.maximum(col_max[c], cols[:nc])
    if scratch:   # every entry written once
        assert row_part.min() >= 0 and col_part.min() >= 0
        return row_part.max(axis=1), col_part.max(axis=0)
    return row_max, col_max


@pytest.mark.parametrize("mkn", WGMMA_CASES)
def test_plain_route_matches_jax_at_the_edge_shapes(mkn):
    """The kernel's tiles and folds (both forms) and the wrappers' plain
    route against the JAX `magmax_matmul_pallas` and
    `magmax_matmul_scratch` in interpret mode."""
    m, k, n = mkn
    rng = np.random.default_rng(400 + m)
    a8 = rng.integers(0, 65, (m, k), dtype=np.int8)
    b8 = rng.integers(0, 65, (k, n), dtype=np.int8)
    ja, jb = jnp.asarray(a8), jnp.asarray(b8)
    refs = [tuple(np.asarray(x) for x in f(ja, jb))
            for f in (pm.magmax_matmul_pallas, pm.magmax_matmul_scratch)]
    np.testing.assert_array_equal(refs[0][0], refs[1][0])
    np.testing.assert_array_equal(refs[0][1], refs[1][1])
    jr, jc = refs[0]
    ta, tb = torch.from_numpy(a8), torch.from_numpy(b8)
    for fn in (hm.magmax_matmul, hm.magmax_matmul_scratch):
        tr, tc = fn(ta, tb)
        np.testing.assert_array_equal(jr, tr.numpy())
        np.testing.assert_array_equal(jc, tc.numpy())
    if m * n <= 200 * 129:   # the mirrored epilogue on every tile
        prod = a8.astype(np.int64) @ b8.astype(np.int64)
        for scratch in (False, True):
            rows, cols = walk_maxima(prod, scratch)
            np.testing.assert_array_equal(jr[:, 0], rows)
            np.testing.assert_array_equal(jc[0], cols)


# ---- the scratch buffers and the tensor maps --------------------------------

@pytest.mark.parametrize("m,n,want", [
    (8192, 8192, ((8192, 32), (64, 8192))), (1, 1, ((1, 1), (1, 1))),
    (65, 257, ((65, 2), (1, 257))), (200, 129, ((200, 1), (2, 129))),
    (1000, 1500, ((1000, 6), (8, 1500)))])
def test_scratch_shapes_follow_the_tile(m, n, want):
    assert hm.magmax_scratch_shapes(m, n, MAG.tile_n) == want
    assert want == ((m, cdiv(n, 256)), (cdiv(m, 128), n))
    # the kernel's stores: column tn of the row buffer, row tm of the
    # column buffer
    assert "p.row_max[static_cast<size_t>(row) * walk.tiles_n + tn] = v;" \
        in MAG_SRC
    assert "p.col_max[static_cast<size_t>(tm) * p.n + col] = v;" in MAG_SRC


@pytest.mark.parametrize("rows,k,ld", [(1, 16, 64), (65, 144, 160),
                                       (200, 4100, 4160), (7, 777, 784)])
def test_tensor_map_extent_is_k_not_ld(rows, k, ld):
    """The map over a K-major (rows, ld) operand stops at k: read through
    it (box rows and 128-byte k boxes past the extent as zeros), a buffer
    whose bytes past k hold 64 gives the maxima of the unpadded operands;
    read to ld, it would not."""
    dims, strides = hm.k_major_map(rows, k, ld)
    assert dims == (k, rows, 1) and strides == (ld, rows * ld)
    assert all(s % 16 == 0 for s in strides)
    rng = np.random.default_rng(k)
    a = rng.integers(0, 65, (rows, k), dtype=np.int8)
    bt = rng.integers(0, 65, (9, k), dtype=np.int8)
    bufs = []
    for x in (a, bt):
        buf = np.full((x.shape[0], ld), 64, np.int8)
        buf[:, :k] = x
        bufs.append(buf)

    def through_map(buf, extent):
        boxes = np.zeros((buf.shape[0], cdiv(ld, 128) * 128), np.int64)
        boxes[:, :extent] = buf[:, :extent]
        return boxes

    want = a.astype(np.int64) @ bt.astype(np.int64).T
    got = through_map(bufs[0], dims[0]) @ through_map(bufs[1], dims[0]).T
    np.testing.assert_array_equal(got, want)
    if ld > k:
        wide = through_map(bufs[0], ld) @ through_map(bufs[1], ld).T
        assert (wide.max(axis=1) > want.max(axis=1)).all()


def test_tensor_map_refusals():
    for rows, k, ld in ((4, 17, 24), (4, 40, 32), (0, 16, 16), (4, 0, 16)):
        with pytest.raises(ValueError, match="K-major"):
            hm.k_major_map(rows, k, ld)


def test_source_maps_at_extent_k():
    assert ("make_tensor_map(&map_a, a, 1, m, k, kBM, lda,\n"
            "                                static_cast<size_t>(m) * lda)"
            in MAG_SRC)
    assert ("make_tensor_map(&map_b, bt, 1, n, k, kBN, ldb,\n"
            "                                static_cast<size_t>(n) * ldb)"
            in MAG_SRC)


def test_wrapper_checks_its_maps_with_the_helper(monkeypatch):
    """The wrapper's operands on the card: mag7's padded K-major buffers
    pass in place, a row-major B is copied K-major, and each map is built
    by `k_major_map` from (rows, k, ld) (the card stubbed: CPU tensors,
    capability (9, 0))."""
    calls = []
    real = hm.k_major_map
    monkeypatch.setattr(hm, "k_major_map",
                        lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(build, "require_device", lambda *t: None)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    k = 100
    buf = torch.zeros((6, 112), dtype=torch.int8)
    bbuf = torch.zeros((5, 112), dtype=torch.int8)
    a, lda, bt, ldb, cfg = hm._magmax_operands(buf[:, :k], bbuf[:, :k].t())
    assert a.data_ptr() == buf.data_ptr() and (lda, ldb) == (112, 112)
    assert bt.data_ptr() == bbuf.data_ptr() and cfg == MAG
    assert calls == [(6, k, 112), (5, k, 112)]
    calls.clear()
    row_major_b = torch.zeros((k, 5), dtype=torch.int8)
    _, _, bt, ldb, _ = hm._magmax_operands(buf[:, :k], row_major_b)
    assert ldb == 112 and tuple(bt.shape) == (5, 112)
    assert calls == [(6, k, 112), (5, k, 112)]
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="compute capability"):
        hm._magmax_operands(buf[:, :k], bbuf[:, :k].t())


# ---- launch entries, build flags, the old tile gone -------------------------

def test_launch_entries_hold_matmul_mods_values():
    """Both kernels run matmul_mod's tile with its values: matmul_crt's
    digit table and counter fit beside the four stages (as
    matmul_reconstruct's), magmax's two buffers of the warps' column
    maxima fit the staging tile."""
    for cfg in (CRT, MAG):
        assert (cfg.tile_n, cfg.stages, cfg.raster_group) == (
            MOD.tile_n, MOD.stages, MOD.raster_group)
    smem = 1024 + MOD.stages * (BM + BN) * 128 + BM * BN + 16 * MOD.stages
    assert smem + 832 + 16 <= 232448
    assert 2 * 8 * BN * 4 <= BM * BN


def test_crt_scratch_follows_its_entry():
    """matmul_crt sizes its residue scratch as matmul_reconstruct does, by
    its own entry's tile."""
    body = (build.CSRC.parent / "hopper" / "matmul.py").read_text()
    body = body[body.index("def matmul_crt("):body.index(
        "def fused_reconstruct_ok(")]
    assert 'launch.get("matmul_crt"' in body
    assert "reconstruct_scratch_shape(" in body and "cfg.tile_n" in body
    assert hm.reconstruct_scratch_shape(14, 8192, 8192, CRT.tile_n, 132) == \
        (132, (132, 14, 128 * 256))


@pytest.mark.parametrize("src,entry", [("magmax.cu", "magmax"),
                                       ("matmul_crt.cu", "matmul_crt")])
def test_sources_on_the_wgmma_tile(src, entry):
    text = (build.CSRC / src).read_text()
    assert build.WGMMA_SOURCES[src] == entry
    assert '#include "wgmma_s8.cuh"' in text
    for old in ('"mma_s8.cuh"', '"crt_gemm.cuh"', '"crt.cuh"'):
        assert f"#include {old}" not in text
    assert "__launch_bounds__(gm8::wg::kThreads, 1)" in text


def test_the_mma_sync_tile_is_gone():
    names = {p.name for p in build.sources()}
    assert not {"mma_s8.cuh", "crt_gemm.cuh"} & names
    for p in build.sources():
        text = p.read_text()
        assert '#include "mma_s8.cuh"' not in text
        assert '#include "crt_gemm.cuh"' not in text
    assert not hasattr(hm, "_crt_scratch") and not hasattr(hm, "_TILE")


def test_wrappers_off_cpu_never_take_the_plain_versions(monkeypatch):
    for name in ("matmul_crt_plain", "magmax_plain", "magmax_scratch_plain"):
        monkeypatch.setattr(hm, name, lambda *a, **k: pytest.fail("plain"))
    a8 = torch.zeros((2, 4, 32), dtype=torch.int8)
    b8 = torch.zeros((2, 32, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        hm.matmul_crt(a8, b8.to("meta"), 2)
    m8 = torch.zeros((4, 32), dtype=torch.int8)
    for fn in (hm.magmax_matmul, hm.magmax_matmul_scratch):
        with pytest.raises(ValueError, match="CUDA"):
            fn(m8, m8.t().to("meta"))
