// The residue slices of a tile of elements through the int8 tensor cores
// (encode.cu): each element's shifted value as byte planes, one
// mma.sync.m16n8k16 contraction of the planes with a per-call table of
// signed weights, one round-to-nearest reduction per residue in integer
// multiply-and-shift.
//
// The form of the contraction: the shifted value |v| < 2^77 (src_word.cuh
// shifted_value) is written as the 10 bytes b_i of its 80-bit two's
// complement where it is negative and not truncated to zero, plus a sign
// plane s (0 or 1), so that v == sum_i b_i 2^(8i) - s 2^80. The planes are
// UNSIGNED bytes (.u8) and the weights SIGNED (.s8): slot l's weight of
// plane i is the centred representative of 2^(8i) mod m (of -2^80 mod m for
// the sign plane), |w| <= 127, so raw = sum_i w_i b_i is exact and
// |raw| <= 10 * 255 * 127 + 127 < 2^19; no ones row or zero-point constant
// is needed (the JAX package's _encode_tile_mxu centres both sides and
// adds them back). For m = 256 the weights are 1, 0, ..., 0: raw is the low
// byte of the two's complement, the residue's int8 bits.
//
// The tail: the accumulator starts at off = ceil(2^19 / m) m, so t = raw +
// off > 0, and q = ((t + h) mul) >> 32 with h = (m - 1) / 2 and mul =
// ceil(2^32 / m) is floor((t + h) / m) for every t + h < 2^24 (the error
// (t + h)(mul - 2^32/m) / 2^32 stays under 1/m); t - q m then lies in
// [-h, m - 1 - h]: the centred residue for odd m, raw's low byte for 256.
// gemmul8_tpu_torch/core/encode.py encode_mxu_weights builds the same
// constants and encode_slices_mxu runs the same arithmetic.
//
// Fragments (PTX m16n8k16, row.col, s8 x u8 -> s32): the slots are M (16 a
// tile; two tiles for 17-20 moduli), the planes K (11 of 16, the rest zero)
// and 8 elements N. Thread (g, t) = (lane / 4, lane % 4) holds A (the
// weights) of slots g and g + 8 at planes 4t..4t+3, B of element column g
// at planes 4t..4t+3, and D of slots g, g + 8 at element columns 2t, 2t + 1.
// Each element's planes are one 16-byte row in shared memory (bytes 0-9 the
// value, byte 10 the sign plane), so ldmatrix (b16 view) hands out exactly
// the B fragments. A warp takes 64 elements at a time, 8 MMAs per slot
// tile; the ldmatrix row addresses put element 16t + 2p + b in column 2t +
// b of MMA p, so thread (g, t) ends with 16 consecutive elements of each of
// its slots, one 16-byte store a slot. encode.cu and the encode riders of
// matmul_rider.cu share the pieces below.
#pragma once

#include "common.cuh"
#include "src_word.cuh"

namespace gm8 {

constexpr int kEncSlots = 32;   // two m-tiles of 16 slots
constexpr int kEncTile = 64;    // elements a warp takes at a time

struct alignas(16) EncMmaTable {
  unsigned w[kEncSlots][4];  // slot l's 16 plane weights, int8, 4 a word
  unsigned mul[kEncSlots];   // ceil(2^32 / m)
  unsigned hmul[kEncSlots];  // h mul, below 2^32
  int off[kEncSlots];        // ceil(2^19 / m) m
  int m[kEncSlots];          // the slot's modulus; 0 past the call's slots
};

namespace {

__device__ __forceinline__ void mma_s8u8_k16(int (&c)[4],
                                             const unsigned (&a)[2],
                                             unsigned b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// four 8 x 16-byte matrices from shared memory; the memory clobber keeps
// it after the stores it reads
__device__ __forceinline__ void enc_ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the 16-byte row of element e (0..63) of a warp's tile: the low three
// bits XOR-ed so that a quarter-warp's stores (elements 16j + 2i + s) and
// each ldmatrix phase's reads (elements 16k + 2p + b) touch 8 distinct
// 16-byte bank groups
__device__ __forceinline__ int enc_row(int e) {
  return e ^ (((e >> 4) & 3) << 1) ^ ((e >> 3) & 1);
}

// the planes of one element: bytes 0-9 the 80-bit two's complement of the
// shifted value where it is negative and nonzero (else the value), byte 10
// that condition, bytes 11-15 zero
template <typename Word>
__device__ __forceinline__ uint4 enc_planes(Word bits, int sft, int q_max) {
  const Shifted v = shifted_value(bits, sft, q_max);
  unsigned long long lo = v.lo;
  unsigned hi = v.hi;
  const bool neg = v.neg && (lo | hi) != 0;
  if (neg) {
    hi = ~hi + (lo == 0 ? 1u : 0u);
    lo = 0ull - lo;
  }
  return make_uint4(static_cast<unsigned>(lo),
                    static_cast<unsigned>(lo >> 32),
                    (hi & 0xFFFFu) | (neg ? 0x10000u : 0u), 0u);
}

// t - floor((t + h) / m) m: the residue byte of one accumulator
__device__ __forceinline__ unsigned enc_reduce(int t, unsigned mul,
                                               unsigned hmul, int m) {
  const unsigned q = static_cast<unsigned>(
      (static_cast<unsigned long long>(static_cast<unsigned>(t)) * mul +
       hmul) >> 32);
  return static_cast<unsigned>(t) - q * static_cast<unsigned>(m);
}

// the 2 x 16-byte ldmatrix.x4 addresses of a lane (c = 0, 1) in a warp's
// plane rows at shared address sbase: lane gives row n = lane % 8 of
// matrix lane / 8, i.e. column n of MMA p = 4c + lane / 8, which holds
// element 16 (n / 2) + 2p + n % 2
__device__ __forceinline__ unsigned enc_ld_addr(unsigned sbase, int c) {
  const int lane = threadIdx.x & 31;
  const int p = 4 * c + (lane >> 3), n = lane & 7;
  return sbase + 16 * enc_row(16 * (n >> 1) + 2 * p + (n & 1));
}

// the B fragments of the warp's 64 elements (the planes stored and the
// warp synchronised before)
__device__ __forceinline__ void enc_frags(const unsigned (&ld_addr)[2],
                                          unsigned (&b)[8]) {
  enc_ldmatrix_x4(b, ld_addr[0]);
  enc_ldmatrix_x4(b + 4, ld_addr[1]);
}

// A lane's weights and reduction constants for its slots g + 8h + 16mt
// (g = lane / 4; kMT slot tiles of 16: 1 up to 16 moduli, 2 up to 32),
// read from the table in shared memory; contract() forms a slot tile's
// accumulators, reduce() packs one slot's 16 residues of this lane's
// elements 16 (lane % 4)..+15, four to a word, element order;
// contract_reduce() does both for the tile's two slots of a lane.
template <int kMT>
struct EncSlots {
  unsigned a[kMT][2], mul[kMT][2], hmul[kMT][2];
  int off[kMT][2], mod[kMT][2];

  __device__ __forceinline__ explicit EncSlots(const EncMmaTable& S) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = 16 * mt + 8 * h + g;
        a[mt][h] = S.w[l][tq];
        mul[mt][h] = S.mul[l];
        hmul[mt][h] = S.hmul[l];
        off[mt][h] = S.off[l];
        mod[mt][h] = S.m[l];
      }
  }

  __device__ __forceinline__ void contract(int mt, const unsigned (&b)[8],
                                           int (&d)[8][4]) const {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      d[p][0] = d[p][1] = off[mt][0];
      d[p][2] = d[p][3] = off[mt][1];
      mma_s8u8_k16(d[p], a[mt], b[p]);
    }
  }

  // both slots' words (w[h][i], h = 0, 1) straight from the fragments,
  // two MMAs at a time: 8 accumulator registers where contract takes 32
  __device__ __forceinline__ void contract_reduce(int mt,
                                                  const unsigned (&b)[8],
                                                  unsigned (&w)[2][4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int d[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        d[q][0] = d[q][1] = off[mt][0];
        d[q][2] = d[q][3] = off[mt][1];
        mma_s8u8_k16(d[q], a[mt], b[2 * i + q]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = enc_reduce(d[j >> 1][2 * h + (j & 1)], mul[mt][h],
                            hmul[mt][h], mod[mt][h]);
        w[h][i] = pack4(r[0], r[1], r[2], r[3]);
      }
    }
  }

  __device__ __forceinline__ void reduce(int mt, int h, const int (&d)[8][4],
                                         unsigned (&w)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = enc_reduce(d[2 * i + (j >> 1)][2 * h + (j & 1)], mul[mt][h],
                          hmul[mt][h], mod[mt][h]);
      w[i] = pack4(r[0], r[1], r[2], r[3]);
    }
  }
};

// two neighbouring elements of a row (zero past c1) and their shifts
template <typename Word>
struct EncPair {
  Word x0, x1;
  int s0, s1;
};

// x's elements (row, col) and (row, col + 1), rbase = row * (x's row
// stride): one 16-byte load for f64 (8 for f32) where both lie before c1
// and the pair is aligned; the shifts per row (axis 1) or per column
// (axis 0)
template <typename Word>
__device__ __forceinline__ EncPair<Word> enc_load_pair(
    const Word* __restrict__ x, const int* __restrict__ sft, size_t rbase,
    int row, int col, int c1, int axis) {
  EncPair<Word> p{0, 0, 0, 0};
  const Word* src = x + rbase + col;
  if (col + 1 < c1 &&
      (reinterpret_cast<uintptr_t>(src) & (2 * sizeof(Word) - 1)) == 0) {
    if constexpr (sizeof(Word) == 8) {
      const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(src));
      p.x0 = v.x;
      p.x1 = v.y;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      p.x0 = v.x;
      p.x1 = v.y;
    }
  } else {
    if (col < c1) p.x0 = __ldg(src);
    if (col + 1 < c1) p.x1 = __ldg(src + 1);
  }
  if (axis == 1) {
    p.s0 = p.s1 = __ldg(sft + row);
  } else {
    if (col < c1) p.s0 = __ldg(sft + col);
    if (col + 1 < c1) p.s1 = __ldg(sft + col + 1);
  }
  return p;
}

// 16 residues of one slot at columns col.. of a row (p: the slot's row
// start); one 16-byte store where they are all inside [.., c1) and aligned
__device__ __forceinline__ void enc_store16(signed char* p, int col, int c1,
                                            const unsigned (&w)[4]) {
  signed char* q = p + col;
  if (col + 16 <= c1 && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (col + i < c1)
        q[i] = static_cast<signed char>(w[i >> 2] >> (8 * (i & 3)));
  }
}

}  // namespace
}  // namespace gm8
