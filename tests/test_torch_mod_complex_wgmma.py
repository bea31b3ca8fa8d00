"""The ping-pong matmul_mod_u8_pipelined (csrc/matmul_mod_pipelined.cu) and
the chained complex GEMM (csrc/matmul_complex.cu), both on the wgmma tile
of csrc/wgmma_s8.cuh: what of them the CPU can hold.

- Exactness of the complex chains: a numpy int64 mirror of the kernel's
  order (each product's terms, the 4-dot chains II -> -II -> + RR and
  c + IR + RI with c = COMPLEX_IM_BIAS, Karatsuba's E, F, G with the
  carried residues e and s) shows that every partial sum, in any order of
  the terms, stays inside int32, and that its residues (the epilogue's
  multiply-and-shift division) are the plain version's
  (`core/slicegemm.matmul_complex_mod`), at k = 2^16 and 2^16 - 16 with
  extreme operands. The plain version is held to the JAX
  `matmul_complex_mod_pallas` (interpret mode) wherever the JAX kernel's
  own int32 chain cannot wrap; where it can (k = 2^16 with -128 in an odd
  lane, reachable only by calling the kernel directly), the exact residue
  is asserted instead (ROADMAP C12).
- The pipelined kernel's wrap: at k = 2^17, uncentered, the plain version
  against the JAX `matmul_mod_u8_pipelined` and `matmul_mod_u8_plain`.
- The walks, mirrored from the sources and the launch table: every tile
  taken once; the ping-pong alternation giving each consumer warpgroup
  every other tile of its block, its turn barriers balanced and free of
  deadlock against the ring; every complex tile running each product of
  its form once, in the order its chains need.
- The build: the launch entries, their -D flags, the library's name
  following them; the wrappers' checks; a tensor off the CPU never takes
  the plain version.

The card holds both kernels to their plain versions (chip_smoke.py phases
3e, 3v, 5c, 5v).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import launch
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SMS = 132                                # the H100's SMs: the grid's most
INT32 = (-(1 << 31), (1 << 31) - 1)
BIAS = hm.COMPLEX_IM_BIAS
KC = tables.MAX_K // 2                   # the complex kernel's k limit
SRC_PIPE = (build.CSRC / "matmul_mod_pipelined.cu").read_text()
SRC_CPLX = (build.CSRC / "matmul_complex.cu").read_text()
PIPE = launch.get("matmul_mod_pipelined", (9, 0))
CPLX = launch.get("matmul_complex", (9, 0))
BM = 128                                 # gm8::wg::kBM


def cdiv(x, y):
    return -(-x // y)


# ---- the complex chains, mirrored ------------------------------------------

def op_a(kara, p):
    """csrc/matmul_complex.cu op_a: product p's A operand (0 Re, 1 Im, 2
    the Karatsuba sum)."""
    return p if kara else 1 - (p & 1)


def op_b(kara, p):
    """csrc/matmul_complex.cu op_b: product p's B operand."""
    return p if kara else (1 if p in (0, 3) else 0)


def test_operand_order_is_the_sources():
    """The mirror's operand tables are the source's, word for word, and
    give 4-dot II, RR, IR, RI and Karatsuba E, F, G."""
    assert "return kara ? p : 1 - (p & 1);" in SRC_CPLX
    assert "return kara ? p : (p == 0 || p == 3) ? 1 : 0;" in SRC_CPLX
    assert f"constexpr int kImBias = -(1 << {(-BIAS).bit_length() - 1})" \
        in SRC_CPLX
    dot = [(op_a(False, p), op_b(False, p)) for p in range(4)]
    assert dot == [(1, 1), (0, 0), (1, 0), (0, 1)]
    kara = [(op_a(True, p), op_b(True, p)) for p in range(3)]
    assert kara == [(0, 0), (1, 1), (2, 2)]


def _span(x, y):
    """(lowest, highest, total): over every order and subset of the terms
    x[l, i, t] * y[l, t, j] of a product, the extremes a partial sum can
    take (the sums of its negative and of its positive terms) and the
    product itself, each (L, m, n) int64."""
    xp, xn = np.maximum(x, 0), np.minimum(x, 0)
    yp, yn = np.maximum(y, 0), np.minimum(y, 0)
    hi = xp @ yp + xn @ yn
    lo = xp @ yn + xn @ yp
    return lo, hi, hi + lo


def _in_int32(*xs):
    return all(x.min() >= INT32[0] and x.max() <= INT32[1] for x in xs)


def mirror(a, b, L, kara):
    """The kernel's chains on int64 parts a = (Re, Im[, Sa]) (L, m, k) and
    b (L, k, n): (re, im) canonical residues by `hm.mod_div`, after
    asserting that no partial sum of any chain leaves int32."""
    prods = [_span(a[op_a(kara, p)], b[op_b(kara, p)])
             for p in range(3 if kara else 4)]
    mods = tables.MODULI[:L]
    re, im = [], []
    if kara:
        (el, eh, e), (fl, fh, f), (gl, gh, g) = prods
        assert _in_int32(el, eh, fl, fh, gl, gh)
        for l, d in enumerate(mods):
            er, fr, gr = (hm.mod_div(x[l], d) for x in (e, f, g))
            s = (er + fr) % d                        # carried
            re.append((er - fr) % d)
            im.append((gr - s) % d)
    else:
        (l1, h1, ii), (l2, h2, rr), (l3, h3, ir), (l4, h4, ri) = prods
        # Re: II from 0, negated, then RR on top
        assert _in_int32(l1, h1, -ii, -ii + l2, -ii + h2)
        # Im: from the bias, IR, then RI on top
        assert _in_int32(BIAS + l3, BIAS + h3, BIAS + ir + l4, BIAS + ir + h4)
        for l, d in enumerate(mods):
            re.append(hm.mod_div(rr[l] - ii[l], d))
            im.append(hm.mod_div(BIAS + ir[l] + ri[l], d, BIAS))
    return np.stack(re), np.stack(im)


def _extreme(pattern, L, m, k, n, seed=0):
    """(a parts, b parts) int8 numpy, three each (the third the Karatsuba
    sums, taken as given: the kernel takes any int8)."""
    rng = np.random.default_rng(seed)
    a = [np.empty((L, m, k), np.int8) for _ in range(3)]
    b = [np.empty((L, k, n), np.int8) for _ in range(3)]
    if pattern == "neg":        # IR + RI = 2^31 at k = 2^16 in every lane
        for x in a + b:
            x[...] = -128
    elif pattern == "pos":
        for x in a + b:
            x[...] = 127
    elif pattern == "mixed":    # RR, II, E, F at their most negative,
        for x in a:             # G at its most positive: G - E - F past 2^31
            x[...] = -128
        for x in b:
            x[...] = 127
        b[2][...] = -128
        a[1][:, ::2] = 127      # and rows of the other sign
        b[1][:, :, 1::2] = -128
    else:                       # "odd": -128 in the odd lanes, random in 256
        for x in a + b:
            x[...] = -128
            x[0] = rng.integers(-128, 128, x.shape[1:], np.int8)
    return a, b


def _plain(a, b, L, centered, kara):
    t = [torch.from_numpy(x) for x in a + b]
    return sg.matmul_complex_mod(t[0], t[1], t[3], t[4], L, centered,
                                 (t[2], t[5]) if kara else None)


PATTERNS = ["neg", "pos", "mixed", "odd"]


@pytest.mark.parametrize("k", [KC, KC - 16])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("form", ["4dot", "kara"])
def test_complex_chains_exact(form, pattern, k):
    """Every moduli lane (L = 20), small m and n: the mirror's chains stay
    inside int32 and give the plain version's residues, centered and not."""
    L, m, n = tables.MAX_MODULI, 3, 2
    kara = form == "kara"
    a, b = _extreme(pattern, L, m, k, n, seed=k)
    re, im = mirror([x.astype(np.int64) for x in a],
                    [x.astype(np.int64) for x in b], L, kara)
    for centered in (False, True):
        got = _plain(a, b, L, centered, kara)
        for want, g in zip((re, im), got):
            if centered:
                want = (want - 128).astype(np.int8)
            np.testing.assert_array_equal(g.numpy(), want)


def test_im_chain_needs_its_bias():
    """At k = 2^16 with -128 operands IR + RI is exactly 2^31: one past
    int32 from 0, inside it from the bias; the lane mod 256 alone would
    survive the wrap."""
    a, b = _extreme("neg", 2, 1, KC, 1)
    ir = a[1][0].astype(np.int64) @ b[0][0]
    ri = a[0][0].astype(np.int64) @ b[1][0]
    assert (ir + ri).item() == 1 << 31
    assert INT32[0] <= (BIAS + ir + ri).item() <= INT32[1]
    assert (1 << 31) % 256 == (-(1 << 31)) % 256
    assert (1 << 31) % 255 != (-(1 << 31)) % 255


@pytest.mark.parametrize("d", tables.MODULI)
def test_mod_div_bias(d):
    """The Im chain's divisor: mod_div(x, d, bias) is (x - bias) mod d for
    every int32 the chain can end at, its edges and random values."""
    lo, hi = INT32[0], (1 << 31) + BIAS
    x = np.concatenate([
        np.random.default_rng(d).integers(lo, hi, 10 ** 5, endpoint=True),
        [lo, lo + 1, hi, hi - 1, BIAS, 0, -1, 1, BIAS + d]])
    np.testing.assert_array_equal(hm.mod_div(x, d, BIAS), (x - BIAS) % d)
    mul, sh, off = hm.mod_divisor(d, BIAS)
    assert (mul, sh) == hm.mod_divisor(d)[:2]
    assert off == (-(1 << 31) - BIAS) % d and 0 <= off < d


def _jax_chain_fits(a, b, kara):
    """(Re, Im): whether the values the JAX kernel's int32 chains end at
    (4-dot RR - II and IR + RI; Karatsuba E - F and G - E - F) lie inside
    int32, per element. Its int32 arithmetic wraps mod 2^32, so where the
    end value fits, the chain is exact whatever its partial sums did."""
    a = [x.astype(np.int64) for x in a]
    b = [x.astype(np.int64) for x in b]
    p = {(i, j): a[i] @ b[j] for i in range(3) for j in range(3)}
    if kara:
        ends = (p[0, 0] - p[1, 1], p[2, 2] - p[0, 0] - p[1, 1])
    else:
        ends = (p[0, 0] - p[1, 1], p[1, 0] + p[0, 1])
    return [(x >= INT32[0]) & (x <= INT32[1]) for x in ends]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("form", ["4dot", "kara"])
def test_plain_matches_pallas_at_the_edge(form, pattern):
    """k = 2^16, L = 3 (moduli 256, 255, 253), centered: the plain version
    against the JAX kernel wherever the JAX kernel's int32 chain fits;
    elsewhere the exact residue, which the JAX kernel's wrapped one misses
    in every odd lane (ROADMAP C12: a defect of the reference the port
    does not copy; the JAX callers never pass -128 to an odd lane, nor
    k = 2^16 to Karatsuba)."""
    L, m, n, k = 3, 2, 2, KC
    kara = form == "kara"
    a, b = _extreme(pattern, L, m, k, n, seed=1)
    ref = pm.matmul_complex_mod_pallas(
        *map(jnp.asarray, (a[0], a[1], b[0], b[1])), L, centered=True,
        kara=(jnp.asarray(a[2]), jnp.asarray(b[2])) if kara else None)
    got = _plain(a, b, L, True, kara)
    exact = mirror([x.astype(np.int64) for x in a],
                   [x.astype(np.int64) for x in b], L, kara)
    for r, g, want, fits in zip(ref, got, exact, _jax_chain_fits(a, b, kara)):
        r, g = np.asarray(r), g.numpy()
        np.testing.assert_array_equal(g, (want - 128).astype(np.int8))
        np.testing.assert_array_equal(g[fits], r[fits])
        wraps = ~fits
        wraps[0] = False                  # the 256 lane survives a wrap
        assert (r[wraps] != g[wraps]).all()


# ---- the pipelined kernel's wrap -------------------------------------------

def test_pipelined_wrap_at_max_k_matches_jax():
    """k = 2^17, m = n = 4, L = 20, uncentered: slice 0 (modulus 256) all
    -128, so its products are exactly 2^31 and wrap (residue 0); the odd
    slices at +-127, their largest products. The plain version is the JAX
    kernel's and matmul_mod_u8's."""
    L, k, mn = tables.MAX_MODULI, tables.MAX_K, 4
    a8 = np.full((L, mn, k), -127, np.int8)
    b8 = np.full((L, k, mn), 127, np.int8)
    a8[0] = -128
    b8[0] = -128
    b8[1:, :, ::2] = -127
    b8[1:, ::3, 1] = -127
    ref = np.asarray(pm.matmul_mod_u8_pipelined(jnp.asarray(a8),
                                                jnp.asarray(b8), L))
    assert (ref[0] == 0).all() and ref.max() > 0
    ta, tb = torch.from_numpy(a8), torch.from_numpy(b8)
    got = hm.matmul_mod_u8_pipelined(ta, tb, L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, hm.matmul_mod_u8_plain(ta, tb, L))


# ---- the walks -------------------------------------------------------------

def tile_at(t, L, m, n, width, group):
    """wgmma_s8.cuh TileWalk.at: (l, tm, tn) of tile t."""
    tiles_m, tiles_n = cdiv(m, BM), cdiv(n, width)
    l, r = divmod(t, tiles_m * tiles_n)
    g, w = divmod(r, group * tiles_n)
    rows = min(group, tiles_m - g * group)
    return l, g * group + w % rows, w // rows


WALK_SHAPES = [(1, 16, 1, 1), (65, 144, 257, 14), (200, 4100, 129, 20),
               (1000, 4100, 1500, 14), (2048, 2048, 2048, 14),
               (300, 131072, 520, 20), (777, 1000, 1333, 14)]
WALK_IDS = [f"{m}x{k}x{n}-L{L}" for m, k, n, L in WALK_SHAPES]


CLUSTER = 2                              # matmul_mod_pipelined.cu kCluster


def _pair_walk(L, m, n):
    """(pairs, clusters, per cluster: the producer's pairs in order and
    each consumer warpgroup's) as the kernel's loops take them: the pair
    walk over pair rows of 2 x 128 rows (produce_pairs: T = cluster,
    + clusters, ...; warpgroup w: T = cluster + w clusters, += 2
    clusters), the grid one cluster per two SMs, no more than the
    pairs."""
    tiles_m = cdiv(m, BM)
    pairs = L * cdiv(tiles_m, CLUSTER) * cdiv(n, PIPE.tile_n)
    grid = min(SMS, CLUSTER * pairs) // CLUSTER * CLUSTER
    clusters = grid // CLUSTER
    return pairs, clusters, [
        (list(range(c, pairs, clusters)),
         [list(range(c + w * clusters, pairs, 2 * clusters)) for w in (0, 1)])
        for c in range(clusters)]


def pair_at(T, rank, L, m, n):
    """PairWalk.at: (l, m-tile, n-tile) of pair T for the block of this
    rank (the walk of wgmma_s8.cuh TileWalk over pair rows, groups of
    raster_group / 2 pair rows)."""
    tiles_m = cdiv(m, BM)
    l, tp, tn = tile_at(T, L, cdiv(tiles_m, CLUSTER) * BM, n, PIPE.tile_n,
                        max(PIPE.raster_group // CLUSTER, 1))
    return l, CLUSTER * tp + rank, tn


def test_pingpong_loops_are_the_sources():
    """The mirror's loops, walk and turn protocol are the source's."""
    for text in ("constexpr int kCluster = 2;",
                 "T = cid + role * clusters; T < walk.pairs.total;",
                 "T += 2 * clusters, j += 2",
                 "if (j > 0) turn_wait(kTurnBarrier + role);",
                 "if (T + clusters < walk.pairs.total)\n"
                 "        turn_pass(kTurnBarrier + 1 - role);",
                 "static_cast<long long>(j) * nk",
                 "for (int T = cid; T < walk.pairs.total; T += clusters)",
                 "tm = min(tm, walk.tiles_m - 1);",
                 "if (tm >= walk.tiles_m) continue;",
                 "kGroup / kCluster > 0 ? kGroup / kCluster : 1",
                 "persistent_grid(pairs * kCluster) / kCluster * kCluster",
                 "mbar_init(ring.empty + 8 * s, kWgWarps * kCluster);"):
        assert text in SRC_PIPE, text


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=WALK_IDS)
def test_pingpong_walk(shape):
    """Every output tile is stored once, by one warpgroup of one block;
    the two blocks of a cluster take the two m-tiles of each pair, with
    one B column of tiles, the second block reloading the last m-tile
    (and storing nothing) where a pair row has one; each warpgroup takes
    every other pair of its cluster (even ones to 0, odd to 1) in the
    producer's order."""
    m, k, n, L = shape
    pairs, clusters, walks = _pair_walk(L, m, n)
    tiles_m, tiles_n = cdiv(m, BM), cdiv(n, PIPE.tile_n)
    stored = []
    for prod, (w0, w1) in walks:
        assert w0 == prod[0::2] and w1 == prod[1::2]
        for T in prod:
            cells = [pair_at(T, r, L, m, n) for r in range(CLUSTER)]
            assert len({(l, tn) for l, _, tn in cells}) == 1
            assert [tm for _, tm, _ in cells] == [cells[0][1] + r
                                                  for r in range(CLUSTER)]
            for l, tm, tn in cells:
                assert 0 <= l < L and tn < tiles_n
                assert min(tm, tiles_m - 1) * BM < m   # the rows it loads
                if tm < tiles_m:
                    stored.append((l, tm, tn))
    assert len(stored) == len(set(stored)) == L * tiles_m * tiles_n


def _simulate_block(n_tiles, nk, stages):
    """One block's schedule, step by step: the producer loads ring step s
    once step s - stages is released; warpgroup w takes its tiles j (j % 2
    == w), waits for its turn before tile j > 0, consumes steps j nk ..
    (j + 1) nk - 1 in order, passes the turn once tile j + 1 exists, then
    runs its epilogue. Returns the order in which the tiles' mainloops
    ran; fails on a deadlock or a stage read before its load."""
    total_steps = n_tiles * nk
    released = 0            # steps released, in order (one reader each)
    turns = {0: 0, 1: 0}    # passes received, per warpgroup
    waited = {0: 0, 1: 0}
    nxt = {0: 0, 1: 1}      # each warpgroup's next tile
    pos = {0: None, 1: None}  # step inside its current mainloop
    order = []
    while released < total_steps or any(nxt[w] < n_tiles for w in (0, 1)):
        moved = False
        for w in (0, 1):
            j = nxt[w]
            if j >= n_tiles:
                continue
            if pos[w] is None:           # before the mainloop: its turn
                if j > 0:
                    if turns[w] <= waited[w]:
                        continue
                    waited[w] += 1
                pos[w] = j * nk
                order.append(j)
                moved = True
                continue
            s = pos[w]
            loaded = s < released + stages   # the producer's ring
            if not loaded or s != released:  # stages release in order
                continue
            released += 1
            pos[w] += 1
            moved = True
            if pos[w] == (j + 1) * nk:       # mainloop issued
                if j + 1 < n_tiles:
                    turns[1 - w] += 1
                pos[w] = None
                nxt[w] += 2
        assert moved, "deadlock"
    assert waited == turns
    return order


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=WALK_IDS)
def test_pingpong_turns_never_deadlock(shape):
    """Each cluster's schedule under the kernel's turn protocol runs to its
    end with every wait matched by a pass, and the tensor cores take the
    cluster's pairs in order, alternating between the warpgroups (both
    blocks of a cluster walk the same pairs, so one block's schedule is
    the cluster's)."""
    m, k, n, L = shape
    nk = cdiv(cdiv(k, 16) * 16, 128)
    _, _, walks = _pair_walk(L, m, n)
    for prod, _ in walks[:3] + walks[-2:]:
        assert _simulate_block(len(prod), min(nk, 4), PIPE.stages) == \
            list(range(len(prod)))


def test_pingpong_shared_memory_fits():
    """The source's shared memory at the table's entry: the alignment
    slack, the ring of 128-row A and B stages, two staging tiles and the
    barriers, within what a block may opt into on sm_90."""
    smem = 1024 + PIPE.stages * (BM + PIPE.tile_n) * 128 \
        + 2 * BM * PIPE.tile_n + 16 * PIPE.stages
    assert smem <= 232448 and PIPE.tile_n == 128
    assert "2 * kStgBytes + 16 * kStages" in SRC_PIPE


@pytest.mark.parametrize("shape", WALK_SHAPES[:5] + [(777, 1000, 1333, 14)],
                         ids=WALK_IDS[:5] + WALK_IDS[-1:])
@pytest.mark.parametrize("form", ["4dot", "kara"])
def test_complex_walk(form, shape):
    """The producer's sequence (tile, product, k-tile) over every block:
    every tile once, each product of its form once a tile with its own
    operand maps, and the consumers' chains read the same sequence: the
    4-dot form's first two products (II, RR) make Re, its last two (IR,
    RI) Im; Karatsuba's E, F, G in order."""
    m, k, n, L = shape
    kara = form == "kara"
    nk = cdiv(cdiv(k, 16) * 16, 128)
    P = 3 if kara else 4
    total = L * cdiv(m, BM) * cdiv(n, CPLX.tile_n)
    G = min(SMS, total)
    seen = []
    for b in range(G):
        steps = [(t, op_a(kara, p), op_b(kara, p), kt)
                 for t in range(b, total, G) for p in range(P)
                 for kt in range(nk)]
        # the consumers: per tile, P products of nk steps, in this order
        it = iter(steps)
        for t in range(b, total, G):
            pairs = []
            for p in range(P):
                got = [next(it) for _ in range(nk)]
                assert {x[0] for x in got} == {t}
                assert [x[3] for x in got] == list(range(nk))
                pairs.append(got[0][1:3])
            if kara:
                assert pairs == [(0, 0), (1, 1), (2, 2)]
            else:
                assert pairs[:2] == [(1, 1), (0, 0)]          # Re: -II + RR
                assert sorted(pairs[2:]) == [(0, 1), (1, 0)]  # Im: IR + RI
            seen.append(t)
        assert next(it, None) is None
    assert sorted(seen) == list(range(total))


def test_complex_walk_mirror_matches_the_kernel_loops():
    """The walk and the chains as the source writes them."""
    for text in ("for (int p = 0; p < kProducts; ++p)",
                 "constexpr int kProducts = kKara ? 3 : 4;",
                 "for (int i = 0; i < kAcc; ++i) acc[i] = -acc[i];",
                 "fill(acc, kImBias);",
                 "gm8::slot_divisors(mods, kImBias)"):
        assert text in SRC_CPLX, text
    assert SRC_CPLX.count("gm8::wg::consume<kBN, true>") == 7  # 3 + 4
    assert '#include "mma_s8.cuh"' not in SRC_CPLX
    assert '#include "mma_s8.cuh"' not in SRC_PIPE


# ---- the build and the wrappers --------------------------------------------

@pytest.mark.parametrize("entry,src,want", [
    ("matmul_mod_pipelined", "matmul_mod_pipelined.cu",
     launch.MatmulModLaunch(tile_n=128, stages=6, raster_group=16)),
    ("matmul_complex", "matmul_complex.cu",
     launch.MatmulModLaunch(tile_n=256, stages=4, raster_group=16))])
def test_launch_entry_and_flags(entry, src, want):
    """The table's sm_90 entry, compiled into its source with -Xptxas -v;
    the source refuses to build without each constant and reads it."""
    cfg = launch.get(entry, (9, 0))
    assert cfg == want
    flags = build.SOURCE_FLAGS[src]
    assert flags[:2] == ("-Xptxas", "-v") and flags[2:] == cfg.defines()
    assert build.WGMMA_SOURCES[src] == entry
    text = (build.CSRC / src).read_text()
    for flag in cfg.defines():
        name = flag[2:].split("=")[0]
        assert f"!defined({name})" in text and f"= {name};" in text


@pytest.mark.parametrize("entry", ["matmul_mod_pipelined", "matmul_complex"])
@pytest.mark.parametrize("cap", [(8, 0), (9, 1), (10, 0)])
def test_launch_entry_unknown_capability_raises(entry, cap):
    with pytest.raises(RuntimeError, match="no launch entry"):
        launch.get(entry, cap)


@pytest.mark.parametrize("src", ["matmul_mod_pipelined.cu",
                                 "matmul_complex.cu"])
def test_build_name_follows_the_launch_entry(tmp_path, monkeypatch, src):
    """Another entry for the source is another library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    names = set()
    for cfg in (launch.get(build.WGMMA_SOURCES[src], (9, 0)),
                launch.MatmulModLaunch(128, 3, 8)):
        monkeypatch.setattr(build, "SOURCE_FLAGS",
                            {src: ("-Xptxas", "-v", *cfg.defines())})
        names.add(build._library(build.sources()))
    assert len(names) == 2


def _parts(L, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return ([torch.from_numpy(rng.integers(-128, 128, (L, m, k), np.int8))
             for _ in range(3)],
            [torch.from_numpy(rng.integers(-128, 128, (L, k, n), np.int8))
             for _ in range(3)])


@pytest.mark.parametrize("bad", ["dtype", "shape", "k", "kara_shape",
                                 "num_moduli"])
def test_complex_wrapper_checks(bad):
    a, b = _parts(3, 4, 32, 5)
    kara, L = (a[2], b[2]), 3
    if bad == "dtype":
        b[1] = b[1].to(torch.int16)
    elif bad == "shape":
        a[1] = a[1][:, :3]
    elif bad == "k":
        a = [torch.zeros((3, 2, KC + 16), dtype=torch.int8)] * 3
        b = [torch.zeros((3, KC + 16, 2), dtype=torch.int8)] * 3
        kara = None
    elif bad == "kara_shape":
        kara = (a[2][:, :, :16], b[2])
    else:
        L = 4
    with pytest.raises((ValueError, TypeError)):
        hm.matmul_complex_mod(a[0], a[1], b[0], b[1], L, kara=kara)


def test_complex_wrapper_at_the_edge_k_runs_plain():
    """k = 2^16 is taken (and KC + 16 refused above)."""
    a, b = _extreme("neg", 2, 1, KC, 1)
    t = [torch.from_numpy(x) for x in a + b]
    re, im = hm.matmul_complex_mod(t[0], t[1], t[3], t[4], 2)
    assert re.tolist() == [[[0]], [[0]]]                 # RR - II = 0
    assert im.tolist() == [[[0]], [[(1 << 31) % 255]]]   # IR + RI = 2^31


@pytest.mark.parametrize("bad", ["dtype", "slices", "inner", "k",
                                 "moduli_dup"])
def test_pipelined_wrapper_checks(bad):
    a, b = _parts(3, 4, 16, 5)
    a8, b8, kw, L = a[0], b[0], {}, 3
    if bad == "dtype":
        a8 = a8.to(torch.int16)
    elif bad == "slices":
        b8 = b8[:2]
    elif bad == "inner":
        b8 = b8[:, :15]
    elif bad == "k":
        a8 = torch.zeros((3, 2, tables.MAX_K + 16), dtype=torch.int8)
        b8 = torch.zeros((3, tables.MAX_K + 16, 2), dtype=torch.int8)
    else:
        kw, L = {"moduli_idx": (1, 1, 2)}, 14
    with pytest.raises((ValueError, TypeError)):
        hm.matmul_mod_u8_pipelined(a8, b8, L, **kw)


def test_wrappers_off_cpu_never_take_the_plain_version():
    """One operand off the CPU: each wrapper goes to its kernel, whose
    device check refuses a tensor that is not on a CUDA card."""
    a, b = _parts(2, 4, 16, 5)
    with pytest.raises(ValueError, match="CUDA"):
        hm.matmul_mod_u8_pipelined(a[0], b[0].to("meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        hm.matmul_complex_mod(a[0], a[1], b[0], b[1].to("meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        hm.matmul_complex_mod(a[0], a[1], b[0], b[1], 2,
                              kara=(a[2].to("meta"), b[2]))


def test_pipelined_moduli_subsets_plain():
    """moduli_idx tuples (in and out of order): the plain version is
    matmul_mod_u8's uncentered residues of each slot's modulus."""
    a, b = _parts(3, 7, 40, 9, seed=3)
    for idx in ((3, 7, 11), (19, 0, 5)):
        got = hm.matmul_mod_u8_pipelined(a[0], b[0], 20, idx)
        assert torch.equal(got, hm.matmul_mod_u8_plain(a[0], b[0], 20,
                                                       moduli_idx=idx))
        prod = a[0].double() @ b[0].double()
        for l, j in enumerate(idx):
            want = prod[l].long() % tables.MODULI[j]
            assert torch.equal(got[l].long(), want)


def test_spill_bytes_reads_the_report(monkeypatch):
    """The spill figures chip_smoke asserts (0 for the wgmma sources) are
    read off each kernel's ptxas lines; a source without a report has
    none to read."""
    report = ("ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
              "ptxas info    : Function properties for k\n"
              "    0 bytes stack frame, 0 bytes spill stores, "
              "0 bytes spill loads\n"
              "ptxas info    : Function properties for t\n"
              "    8 bytes stack frame, 12 bytes spill stores, "
              "4 bytes spill loads\n")
    monkeypatch.setattr(build, "PTXAS_REPORT", {"x.cu": report})
    assert build.spill_bytes("x.cu") == [0, 0, 12, 4]
    with pytest.raises(KeyError):
        build.spill_bytes("matmul_complex.cu")
