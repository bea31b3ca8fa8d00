"""The rider kernel on the wgmma tile (csrc/matmul_rider.cu): what of it the
CPU can hold.

- The persistent walk, mirrored from the source's constants: across all
  blocks every GEMM tile, reconstruct chunk and encode unit is taken
  exactly once, every block holds its share of the rider work (within one
  piece of any other's), and the rider work covers each rider's elements
  exactly once (the reconstruct's chunks and their lanes' tail elements,
  the A encode's 16-column pieces of each row, the B encode's 16-row x
  1-column pieces of its half of B, none left of it). Shapes: chip_smoke's PIPELINE_CASES, the
  main path's 8192 panel, a pair whose half is not a multiple of the
  256-wide tile, and a ragged panel.
- The tensor maps' windows: every row a TMA box of A reads lies in
  [a_row0, a_row0 + pm) of its slice, every row of B in [c0, c1), and the
  columns at or past c1 (launch 0a's rider writes them) fall outside the
  map, so they load as zeros; the residue store keeps to pm rows and
  [c0, c1).
- The wrappers' checks (alignment, k, the column window) raise, and a
  tensor off the CPU never takes the plain version.
- The build: the source's flags (the matmul_mod launch entry and `-Xptxas
  -v`), the library's name following them, the riders' tables and the
  setter's signature.

The card holds the kernel to its plain versions (chip_smoke.py phases 3p,
3r, 5p, 5r).
"""

import re

import numpy as np
import pytest
import torch

from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import launch
from gemmul8_tpu_torch.hopper import pipelined as hp

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SRC = (build.CSRC / "matmul_rider.cu").read_text()
SMS = 132                              # the H100's SMs: the grid's most
MM = launch.get("matmul_rider", (9, 0))  # the kernel's launch entry


def _const(name):
    """A `constexpr int name = <int>;` of the rider source."""
    found = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert found, f"{name} not in matmul_rider.cu"
    return int(found.group(1))


BM, BN = 128, MM.tile_n
WARPS = 8                              # gm8::wg::kConsumerWarps
REC_CHUNK = _const("kRecChunk")
ENC_TILE = 64                          # gm8::kEncTile
B_ROWS, B_COLS = _const("kBRows"), _const("kBCols")
A_TILES, B_TILES = _const("kATiles"), _const("kBTiles")


def cdiv(x, y):
    return -(-x // y)


def tile_at(t, L, pm, width, group):
    """wgmma_s8.cuh TileWalk.at: (l, tm, tn) of GEMM tile t."""
    tiles_m, tiles_n = cdiv(pm, BM), cdiv(width, BN)
    per_l = tiles_m * tiles_n
    l, r = divmod(t, per_l)
    g, w = divmod(r, group * tiles_n)
    rows = min(group, tiles_m - g * group)
    return l, g * group + w % rows, w // rows


def work(L, pm, n, k, c0, c1, rec, enc, benc_c0=None):
    """launch()'s counts: (GEMM tiles, reconstruct chunks, A encode units,
    B encode units)."""
    gemm = L * cdiv(pm, BM) * cdiv(c1 - c0, BN)
    r = cdiv(pm * n, REC_CHUNK) if rec else 0
    a = cdiv(pm * cdiv(k, ENC_TILE), A_TILES) if enc else 0
    b = (cdiv(k, B_TILES * B_ROWS) * cdiv(n - benc_c0, B_COLS)
         if benc_c0 is not None else 0)
    return gemm, r, a, b


def block_share(count, b, P):
    """Block b's share of `count` pieces of one kind of work on P blocks:
    the GEMM tiles its producer loads and its consumers take, in order
    (wgmma_s8.cuh produce and the consumers' loop), and the reconstruct
    chunks and encode units its warps take off the block's counters
    (rec_chunks, enc_units_mt), whichever warp takes each."""
    return list(range(b, count, P))


# (name, L, pm, n, k, c0, c1, rec, enc, B rider's first column or None)
LAUNCHES = []
for (m, k, n), Ls, pm in [((2048, 2048, 2048), (14,), 1024),
                          ((768, 384, 1024), (2, 8, 14, 20), 256),
                          ((1536, 1024, 1024), (14,), 512),
                          ((8192, 8192, 8192), (14,), 1024),
                          ((512, 384, 1280), (14, 20), 256),
                          ((600, 272, 1000), (2, 20), 200)]:
    for L in Ls:
        h = n // 2
        tag = f"{m}x{k}x{n}-L{L}-pm{pm}"
        LAUNCHES += [(f"step-{tag}", L, pm, n, k, 0, n, True, True, None),
                     (f"step-norider-{tag}", L, pm, n, k, 0, n, False, False,
                      None),
                     (f"pair0a-{tag}", L, pm, n, k, 0, h, False, False, h),
                     (f"pair0b-{tag}", L, pm, n, k, h, n, False, True, None)]
IDS = [x[0] for x in LAUNCHES]


@pytest.mark.parametrize("case", LAUNCHES, ids=IDS)
def test_walk_takes_every_piece_once(case):
    """Across the grid (one block an SM, no more than the GEMM tiles) every
    GEMM tile, reconstruct chunk and encode unit is taken exactly once;
    each tile (l, tm, tn) lies in the launch's window."""
    _, L, pm, n, k, c0, c1, rec, enc, bc0 = case
    G, R, A, B = work(L, pm, n, k, c0, c1, rec, enc, bc0)
    P = min(SMS, G)
    for count in (G, R, A + B):
        taken = [x for b in range(P) for x in block_share(count, b, P)]
        assert sorted(taken) == list(range(count))
    assert not (A and B)   # one encode rider a launch
    tiles = {tile_at(t, L, pm, c1 - c0, MM.raster_group) for t in range(G)}
    assert tiles == {(l, tm, tn) for l in range(L)
                     for tm in range(cdiv(pm, BM))
                     for tn in range(cdiv(c1 - c0, BN))}


@pytest.mark.parametrize("case", LAUNCHES, ids=IDS)
def test_rider_work_spreads_over_every_block(case):
    """Every block holds rider work from the launch's start to its end:
    its shares of the reconstruct chunks and of the encode units differ
    from any other block's by one piece at most, so every SM meets riders
    beside its GEMM tiles, which differ by one tile at most."""
    _, L, pm, n, k, c0, c1, rec, enc, bc0 = case
    G, R, A, B = work(L, pm, n, k, c0, c1, rec, enc, bc0)
    P = min(SMS, G)
    for count in (G, R, A + B):
        sizes = [len(block_share(count, b, P)) for b in range(P)]
        assert max(sizes) - min(sizes) <= 1
        if count >= P:
            assert min(sizes) >= 1


@pytest.mark.parametrize("case", LAUNCHES, ids=IDS)
def test_rider_work_covers_its_elements(case):
    _, L, pm, n, k, c0, c1, rec, enc, bc0 = case
    _, nrec, na, nb = work(L, pm, n, k, c0, c1, rec, enc, bc0)
    if rec:   # rec_chunks: chunk c holds elements 128 c .. of the flat rows
        # each lane's tail elements in the two halves of a chunk
        el = [16 * (idx >> 3) + 8 * h + (idx & 7) for h in (0, 1)
              for idx in range(64)]
        assert sorted(el) == list(range(REC_CHUNK))
        e = (np.arange(nrec)[:, None] * REC_CHUNK + np.array(el)).ravel()
        assert np.array_equal(np.sort(e[e < pm * n]), np.arange(pm * n))
    if enc:   # a_unit: unit u holds 64-column tiles A_TILES u + i of the
        # row-major walk (none past the panel's last row)
        ntc = cdiv(k, ENC_TILE)
        cells = sorted((t // ntc, t % ntc * ENC_TILE + 16 * tq)
                       for u in range(na)
                       for t in range(A_TILES * u, A_TILES * u + A_TILES)
                       for tq in range(4)
                       if t // ntc < pm and t % ntc * ENC_TILE + 16 * tq < k)
        assert cells == [(r, c) for r in range(pm) for c in range(0, k, 16)]
    if bc0 is not None:   # b_unit: the 16-row pieces its stores write
        groups = cdiv(n - bc0, B_COLS)
        pieces = []
        for u in range(nb):
            kb, cg = divmod(u, groups)
            cw, k0 = bc0 + cg * B_COLS, B_TILES * kb * B_ROWS
            tiles = min(B_TILES, (k - k0) // B_ROWS)
            # the tiles' residues staged, then a slot's pieces out: piece
            # p is tile p % tiles of column p // tiles
            for p in range(B_COLS * tiles):
                i, c = p % tiles, p // tiles
                if cw + c < n:
                    pieces.append((k0 // B_ROWS + i, cw + c))
        want = [(kb, col) for kb in range(k // B_ROWS)
                for col in range(bc0, n)]
        assert sorted(pieces) == want
        assert k % B_ROWS == 0   # every piece is 16 whole rows of k


def _map_rows(base_row, rows, box0, box_rows):
    """The global rows a TMA box reads from a map over rows [base_row,
    base_row + rows) of its slice (make_tensor_map: base = ptr + base_row *
    ld, dim 1 = rows): rows of the box past `rows` are out of bounds and
    land in shared memory as zeros."""
    r = np.arange(box0, box0 + box_rows)
    return base_row + r[r < rows]


@pytest.mark.parametrize("case", LAUNCHES, ids=IDS)
def test_tensor_map_windows(case):
    _, L, pm, n, k, c0, c1, *_ = case
    a_rows = 3 * pm if pm * 3 <= 8192 else pm
    a_row0 = a_rows - pm            # the last panel of A
    for tm in range(cdiv(pm, BM)):
        got = _map_rows(a_row0, pm, tm * BM, BM)
        assert got.min() >= a_row0 and got.max() < a_row0 + pm
        assert len(got) == min(BM, pm - tm * BM)
    read = set()
    for tn in range(cdiv(c1 - c0, BN)):
        got = _map_rows(c0, c1 - c0, tn * BN, BN)
        assert got.min() >= c0 and got.max() < c1
        read |= set(got.tolist())
    assert read == set(range(c0, c1))
    # launch 0a's last tile straddles c1 where the half is not a multiple
    # of the tile: its rows past c1 are outside the map (zeros), never the
    # columns the B rider writes in the same launch
    last = (cdiv(c1 - c0, BN) - 1) * BN
    assert not set(range(c0 + last, c0 + last + BN)) - set(range(c1)) & read
    # the residue store: element (row, col) of slice l at l pm n + row n +
    # col, kept where row < pm and col < c1, in columns from c0
    for tm in range(cdiv(pm, BM)):
        for tn in range(cdiv(c1 - c0, BN)):
            rows = np.arange(tm * BM, tm * BM + BM)
            cols = c0 + tn * BN + np.arange(BN)
            kept = (rows[:, None] < pm) & (cols[None, :] < c1)
            assert kept.sum() == (min(BM, pm - tm * BM)
                                  * min(BN, c1 - c0 - tn * BN))


def _slices(L, rows, k, n):
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-128, 128, (L, rows, k)).astype(
        np.int8))
    bt = torch.from_numpy(rng.integers(-128, 128, (L, n, k)).astype(np.int8))
    return a8, bt


def test_check_kernel_args_alignment():
    a8, bt = _slices(2, 4, 32, 6)
    hp._check_kernel_args(32, 6, False, a8=a8, bt=bt)
    flat = torch.zeros(2 * 4 * 32 + 1, dtype=torch.int8)
    skew = flat[1:].view(2, 4, 32)
    assert skew.data_ptr() % 16
    with pytest.raises(ValueError, match="a8 must start 16-byte aligned"):
        hp._check_kernel_args(32, 6, False, a8=skew, bt=bt)
    with pytest.raises(ValueError, match="a8_p0 must start 16-byte aligned"):
        hp._check_kernel_args(32, 6, True, a8_p0=skew)


@pytest.mark.parametrize("k,n,pair,ok", [(16, 1, False, True),
                                         (0, 4, False, False),
                                         (0, 4, True, False),
                                         (32, 0, False, False),
                                         (32, 2, True, True),
                                         (32, 0, True, False)])
def test_check_kernel_args_k_and_window(k, n, pair, ok):
    if ok:
        hp._check_kernel_args(k, n, pair)
    else:
        with pytest.raises(ValueError):
            hp._check_kernel_args(k, n, pair)


def test_wrappers_check_k_multiple_of_16():
    a8, bt = _slices(2, 4, 24, 6)
    sa = torch.zeros((4, 1), dtype=torch.int32)
    sb = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        hp.matmul_rider_step(a8, bt, 0, None, -1, sa, sb, 2, 4)
    b8 = bt.transpose(1, 2).contiguous()
    b_src = torch.zeros((24, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of 16"):
        hp.matmul_bsplit_pair(a8, b8, b_src, sa, sb, 2, 4)


def test_wrappers_off_cpu_never_take_the_plain_version(monkeypatch):
    """One operand off the CPU: both wrappers go to the kernel, whose
    device check refuses a tensor that is not on a CUDA card; the plain
    versions are never called."""
    monkeypatch.setattr(hp, "matmul_rider_step_plain",
                        lambda *a, **k: pytest.fail("plain step"))
    monkeypatch.setattr(hp, "matmul_bsplit_pair_plain",
                        lambda *a, **k: pytest.fail("plain pair"))
    a8, bt = _slices(2, 4, 32, 6)
    sa = torch.zeros((4, 1), dtype=torch.int32)
    sb = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hp.matmul_rider_step(a8, bt.to("meta"), 0, None, -1, sa, sb, 2, 4)
    b8 = bt.transpose(1, 2).contiguous()
    b_src = torch.zeros((32, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        hp.matmul_bsplit_pair(a8, b8, b_src.to("meta"), sa, sb, 2, 4)


def test_build_flags_of_the_rider_source():
    """The rider source takes its launch entry, matmul_mod's tile with a
    stage fewer (its encode warps' shared memory), and `-Xptxas -v`; it
    reads every constant and refuses to build without them."""
    flags = build.SOURCE_FLAGS["matmul_rider.cu"]
    assert flags == ("-Xptxas", "-v", *MM.defines())
    mod = launch.get("matmul_mod", (9, 0))
    assert (MM.tile_n, MM.raster_group, MM.stages) == (
        mod.tile_n, mod.raster_group, mod.stages - 1)
    for flag in MM.defines():
        name = flag[2:].split("=")[0]
        assert f"!defined({name})" in SRC and f"= {name};" in SRC
    # it runs the wgmma tile and the tensor-core bodies, none of the old
    assert '#include "wgmma_s8.cuh"' in SRC
    for old in ('"mma_s8.cuh"', '"residue.cuh"', '"crt.cuh"'):
        assert f"#include {old}" not in SRC


def test_build_name_follows_the_rider_flags(tmp_path, monkeypatch):
    """Another launch entry for the rider source is another library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    names = []
    for entry in (MM, launch.MatmulModLaunch(256, 3, 8)):
        monkeypatch.setattr(build, "SOURCE_FLAGS", {
            "matmul_rider.cu": ("-Xptxas", "-v", *entry.defines())})
        names.append(build._library(build.sources()))
    assert names[0] != names[1]


def test_rider_tables_and_setter_signature():
    """The blob gm8_set_rider_tables takes: encode.cu's table of moduli
    0..19, then the CRT digit table of each moduli count 0..20 (zeros below
    2), at the sizes of EncMmaTable and CrtMmaTable."""
    blob = hp.rider_tables()
    enc = hk.encode_mma_table(tuple(range(tables.MAX_MODULI)))
    crt = len(hk.crt_mma_table(2))
    assert enc.nbytes == 1024 and crt == 832
    assert blob.nbytes == enc.nbytes + (tables.MAX_MODULI + 1) * crt
    assert np.array_equal(blob[:enc.nbytes], enc)
    at = lambda L: blob[enc.nbytes + L * crt:enc.nbytes + (L + 1) * crt]
    assert not at(0).any() and not at(1).any()
    for L in range(2, tables.MAX_MODULI + 1):
        assert np.array_equal(at(L), hk.crt_mma_table(L))
    # slot l's table entry depends on modulus l alone: the first L slots
    # of the 20-slot table are the L-moduli call's
    def split(t):   # (weights (32, 16), mul/hmul/off/m (4, 32))
        return t[:512].reshape(32, 16), t[512:].view(np.uint32).reshape(4, 32)
    w, cols = split(enc)
    for L in (2, 14, 17):
        wl, cl = split(hk.encode_mma_table(tuple(range(L))))
        np.testing.assert_array_equal(w[:L], wl[:L])
        np.testing.assert_array_equal(cols[:, :L], cl[:, :L])
    assert build._SIGNATURES["gm8_set_rider_tables"] == [build._P, build._I]
    assert "GM8_EXPORT int gm8_set_rider_tables(const void* blob, int " \
           "nbytes)" in SRC
