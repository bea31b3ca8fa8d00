// The CRT contraction on the int8 tensor cores, shared by the reconstruct
// kernel (reconstruct.cu), the pipeline's reconstruct rider
// (matmul_rider.cu), the two CRT-fused GEMMs (matmul_reconstruct.cu,
// matmul_crt.cu), the mxu_crt probe (probe_mxu_crt.cu) and the deaddep
// probe's recmxu rider (probe_deaddep.cu).
//
// For centred residues rc_j = r_j - 128 of one element, Y[d] = sum_j
// wc[d][j] rc_j over the compact table wc ((nd+1) x L, nd = 2 * num_limbs;
// gemmul8_tpu_torch/core/reconstruct.py crt_mxu_weights): row d < nd is
// byte-digit d of each CRT weight minus 128, row nd all ones (S). Limb l of
// the weighted sum X = sum_j w_j r_j is then
//   Y[2l] + 256 Y[2l+1] + 32896 S + CL[l]
// (nonnegative, below 2^29). The TPU kernel (pallas/kernels.py
// _crt_accumulate_mxu) multiplied the block-diagonal W' = wc kron I_bm so
// its matrix unit could take a block of bm rows at once; on the card one
// mma.sync.m16n8k32 takes 16 elements as M, the moduli (L <= 20, padded
// with zeros to 32) as K and 8 digits as N: three n-tiles cover nd + 1 <= 23
// digits.
//
// Fragments (PTX m16n8k32 .s8, row.col): thread (g, t) = (lane / 4,
// lane % 4) holds A rows g and g + 8 at k = 4t..4t+3 (regs 0, 1) and
// 16 + 4t.. (regs 2, 3); B column g at k = 4t.. (reg 0) and 16 + 4t..
// (reg 1); D rows g, g + 8 at columns 2t, 2t + 1. The residues arrive as
// (L, elements) planes, so a thread loads one 32-bit word (4 consecutive
// elements) from each of its 4 moduli and transposes the 4 x 4 bytes with
// byte permutes (int8 has no transposing ldmatrix): word e then holds
// element e's four moduli, an A register. The 4 elements of group g fill
// rows g and g + 8 of two MMAs (p = 0, 1): row g of MMA p is element
// 4g + 2p, row g + 8 element 4g + 2p + 1.
#pragma once

#include <cstring>

#include "common.cuh"
#include "moduli.cuh"

namespace gm8 {

constexpr int kCrtDigits = 24;  // nd + 1 <= 23, three n-tiles of 8
constexpr int kCrtK = 32;       // moduli, padded to the MMA depth
constexpr int kCrtTiles = kCrtDigits / 8;

struct alignas(16) CrtMmaTable {
  signed char w[kCrtDigits][kCrtK];  // wc[d][j]; zero past nd and L
  int cl[12];                        // CL[l], l < num_limbs
  int nd;                            // 2 * num_limbs
  int pad[3];
};

// The digit table from the CRT weights and M of a CrtTable, on the host
// (the bytes of hopper/kernels.py crt_mma_table; core/reconstruct.py
// crt_mxu_weights): nl 16-bit limbs hold 255 L M; row d < 2 nl is byte d
// of each weight's limbs minus 128, row 2 nl all ones; CL[l] = C[2l] + 256
// C[2l + 1], C[d] = 128 sum_j wc[d][j] + 128^2 L. For the CRT-fused GEMMs,
// whose C signatures take the CrtTable.
inline CrtMmaTable crt_mma_table(const CrtTable& T, int L) {
  unsigned long long x[kWords + 1];
  unsigned long long carry = 0;
  for (int w = 0; w < kWords; ++w) {
    const unsigned long long v =
        static_cast<unsigned long long>(T.big_m[w]) * (255ull * L) + carry;
    x[w] = v & 0xFFFFFFFFull;
    carry = v >> 32;
  }
  x[kWords] = carry;
  int bits = 0;
  for (int w = kWords; w >= 0 && bits == 0; --w)
    for (int b = 31; b >= 0; --b)
      if ((x[w] >> b) & 1) {
        bits = 32 * w + b + 1;
        break;
      }
  const int nl = (bits + 15) / 16;
  CrtMmaTable W;
  std::memset(&W, 0, sizeof(W));
  W.nd = 2 * nl;
  for (int d = 0; d < W.nd; ++d) {
    long long sum = 0;
    for (int j = 0; j < L; ++j) {
      const unsigned limb = (T.w[j][d / 4] >> (16 * ((d / 2) & 1))) & 0xFFFFu;
      const int byte = static_cast<int>((d & 1) ? limb >> 8 : limb & 0xFFu);
      W.w[d][j] = static_cast<signed char>(byte - 128);
      sum += byte - 128;
    }
    const long long c = 128 * sum + 128 * 128 * L;
    if (d & 1)
      W.cl[d / 2] += static_cast<int>(c << 8);
    else
      W.cl[d / 2] += static_cast<int>(c);
  }
  for (int j = 0; j < L; ++j) W.w[W.nd][j] = 1;
  return W;
}

namespace {

// the 4 x 4 byte transpose: in word i byte e is element e of modulus i;
// out word e byte i likewise (transpose_b.cuh's permutes)
__device__ __forceinline__ void transpose4(const unsigned (&w)[4],
                                           unsigned (&o)[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// B fragments of the three n-tiles: column d = 8q + g, k = 4t.. and 16+4t..
__device__ __forceinline__ void crt_b_frags(const CrtMmaTable& W,
                                            unsigned (&bf)[kCrtTiles][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < kCrtTiles; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bf[q][h] = *reinterpret_cast<const unsigned*>(
          &W.w[8 * q + g][16 * h + 4 * t]);
}

// c[p][q] += D of MMA p, n-tile q, from the transposed words lo (moduli
// 4t..4t+3) and hi (16+4t..) of this thread's 4 elements
__device__ __forceinline__ void crt_mma_acc(
    const unsigned (&lo)[4], const unsigned (&hi)[4],
    const unsigned (&bf)[kCrtTiles][2], int (&c)[2][kCrtTiles][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned a[4] = {lo[2 * p], lo[2 * p + 1], hi[2 * p],
                           hi[2 * p + 1]};
#pragma unroll
    for (int q = 0; q < kCrtTiles; ++q) mma_s8(c[p][q], a, bf[q]);
  }
}

// c[p][q] = D of MMA p, n-tile q (crt_mma_acc from zero)
__device__ __forceinline__ void crt_mma(const unsigned (&lo)[4],
                                        const unsigned (&hi)[4],
                                        const unsigned (&bf)[kCrtTiles][2],
                                        int (&c)[2][kCrtTiles][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < kCrtTiles; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[p][q][r] = 0;
  crt_mma_acc(lo, hi, bf, c);
}

// the bytes of elements e0..e0+15 of plane j of (L, mn) residues at r,
// four to a word, ^ 0x80 in every byte when `centre` (canonical uint8 in,
// centred out); 0 past L and past mn; vec: one 16-byte load (mn % 16 == 0
// and r 16-byte aligned)
__device__ __forceinline__ void crt_load16(unsigned (&w)[4],
                                           const unsigned char* __restrict__ r,
                                           int j, size_t e0, int L, size_t mn,
                                           bool vec, bool centre) {
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0u;
  if (j >= L || e0 >= mn) return;
  const unsigned char* q = r + static_cast<size_t>(j) * mn + e0;
  if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (e0 + b < mn)
        w[b >> 2] |= static_cast<unsigned>(__ldg(q + b)) << (8 * (b & 3));
  }
  if (centre) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] ^= 0x80808080u;
  }
}

}  // namespace
}  // namespace gm8
