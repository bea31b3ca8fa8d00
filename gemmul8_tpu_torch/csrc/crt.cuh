// The CRT sum and the rounding tail of the deaddep probe's rec riders
// (probe_deaddep.cu); the reconstruct kernel, the pipeline's rider and
// the CRT-fused GEMMs (matmul_reconstruct.cu, matmul_crt.cu) run the
// tensor-core form (crt_mma.cuh, crt_tail.cuh), which gives the same bits:
//   crt_add     acc += w_j * r_j           (64-bit column sums of six words)
//   crt_words   column sums -> the integer X as six 32-bit words
//   crt_add_limb  acc += a 16-bit limb (>= 0, < 2^29) at its place
//   crt_center  X -> |centered(X mod M)| and its sign
//   crt_round_f64   RNE( +-magnitude * 2^e_fix ) as f64 bits
// The whole integer of one output element lives in one thread's registers
// (X < 255 * 20 * M < 2^170). The quotient X / M is estimated in f64
// (biased one low, then at most two exact subtractions of M), and the
// rounding extracts the mantissa with funnel shifts over the words and the
// bit position from __clz. Every step is exact, so the result has the bits
// of the plain version.
//
// The constants of one moduli count (weight words, M, floor(M/2) + 1, 1/M)
// are a CrtTable (moduli.cuh), built by the Python wrapper. __constant__ memory is per
// translation unit: reconstruct.cu keeps a table of every moduli count
// there (set once per device); the GEMM kernels take their one entry by
// value as a __grid_constant__ kernel parameter, so they have no table to
// set.
#pragma once

#include "common.cuh"
#include "moduli.cuh"

namespace gm8 {
namespace {

__device__ __forceinline__ unsigned word_at(const unsigned* x, int i) {
  return i < kWords ? x[i] : 0u;
}

// bits [s, s + 64) of the multi-word integer x
__device__ __forceinline__ unsigned long long bits_at(const unsigned* x,
                                                      int s) {
  int ws = s >> 5, b = s & 31;
  unsigned long long v =
      (static_cast<unsigned long long>(word_at(x, ws + 1)) << 32) |
      word_at(x, ws);
  v >>= b;
  if (b) v |= static_cast<unsigned long long>(word_at(x, ws + 2)) << (64 - b);
  return v;
}

// acc += w_j * r for a canonical residue r < 256; after 20 moduli each
// 64-bit column sum is below 20 * 255 * 2^32
__device__ __forceinline__ void crt_add(unsigned long long (&acc)[kWords],
                                        const CrtTable& T, int j,
                                        unsigned r) {
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    acc[w] += static_cast<unsigned long long>(T.w[j][w]) * r;
}

// the column sums carried into 32-bit words
__device__ __forceinline__ void crt_words(
    const unsigned long long (&acc)[kWords], unsigned (&x)[kWords]) {
  unsigned long long carry = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    unsigned long long s = acc[w] + carry;
    x[w] = static_cast<unsigned>(s);
    carry = s >> 32;
  }
}

// acc += limb * 2^(16 i): limb i of an integer held as 16-bit limbs, each
// nonnegative and below 2^29 (canonical or not), i < 2 * kWords
__device__ __forceinline__ void crt_add_limb(
    unsigned long long (&acc)[kWords], int i, unsigned limb) {
  acc[i >> 1] += static_cast<unsigned long long>(limb) << (16 * (i & 1));
}

// mag = |centered(X mod M)|, returns whether it is negative; x holds X on
// entry and is overwritten
__device__ __forceinline__ bool crt_center(unsigned (&x)[kWords],
                                           const CrtTable& T,
                                           unsigned (&mag)[kWords]) {
  // X mod M: f64 quotient estimate, biased low so t - 1 <= t_est <= t
  double xd = 0.0;
#pragma unroll
  for (int w = kWords - 1; w >= 0; --w)
    xd = __dadd_rn(__dmul_rn(xd, 4294967296.0), static_cast<double>(x[w]));
  long long t_est =
      static_cast<long long>(floor(__dmul_rn(xd, T.rinv) - 1e-6));
  if (t_est < 0) t_est = 0;
  long long borrow = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    long long v = static_cast<long long>(x[w]) -
                  t_est * static_cast<long long>(T.big_m[w]) + borrow;
    x[w] = static_cast<unsigned>(v);
    borrow = v >> 32;  // arithmetic: floor division by 2^32
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // x in [0, 3M) -> [0, M)
    unsigned d[kWords];
    long long b = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      long long v = static_cast<long long>(x[w]) - T.big_m[w] + b;
      d[w] = static_cast<unsigned>(v);
      b = v >> 32;
    }
    if (b == 0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) x[w] = d[w];
    }
  }
  // center: x > M/2 (x >= half1) stands for x - M
  long long bh = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    bh = (static_cast<long long>(x[w]) - T.half1[w] + bh) >> 32;
  const bool neg = bh == 0;
  if (neg) {
    long long b = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      long long v = static_cast<long long>(T.big_m[w]) - x[w] + b;
      mag[w] = static_cast<unsigned>(v);
      b = v >> 32;
    }
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) mag[w] = x[w];
  }
  return neg;
}

// RNE( (-1)^neg * mag * 2^e_fix ) into an IEEE word of kMant significand
// bits (53: f64, 24: f32), exponent bias kBias and all-ones exponent
// kExpMax; subnormals, zero and overflow to inf included. The integer is
// rounded once, straight to the target width. A caller loads its shifts
// between crt_center and this, so they are not live across the reduction.
template <int kMant, int kBias, int kExpMax>
__device__ __forceinline__ unsigned long long crt_round(
    const unsigned (&mag)[kWords], bool neg, int e_fix) {
  constexpr int kSign = kMant == 53 ? 63 : 31;
  int p = -1;
#pragma unroll
  for (int w = kWords - 1; w >= 0; --w)
    if (p < 0 && mag[w]) p = 32 * w + 31 - __clz(mag[w]);
  unsigned long long bits;
  const int eb = p + e_fix + kBias;
  if (p < 0) {
    bits = 0;
  } else if (eb >= kExpMax) {
    bits = static_cast<unsigned long long>(kExpMax) << (kMant - 1);
  } else {
    // shift the msb to bit kMant - 1, plus the subnormal extension
    int sr = p - (kMant - 1) + (eb < 1 ? 1 - eb : 0);
    unsigned long long mant;
    if (sr <= 0) {
      mant = bits_at(mag, 0) << (-sr);
    } else {
      sr = min(sr, 32 * kWords + 1);  // beyond it every bit is dropped
      mant = bits_at(mag, sr);
      const int rb = sr - 1;
      const unsigned rword = word_at(mag, rb >> 5);
      const bool rbit = (rword >> (rb & 31)) & 1u;
      bool sticky = (rword & ((1u << (rb & 31)) - 1u)) != 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        sticky |= (w < (rb >> 5)) && mag[w] != 0;
      mant += (rbit && (sticky || (mant & 1ull))) ? 1ull : 0ull;
    }
    // normal: adding the mantissa with its implicit bit to (eb-1) <<
    // (kMant-1) carries a rounding overflow into the exponent (and to
    // inf); subnormal: a round-up into bit kMant-1 yields the smallest
    // normal
    bits = eb < 1 ? mant
                  : (static_cast<unsigned long long>(eb - 1) << (kMant - 1)) +
                        mant;
  }
  return bits | (static_cast<unsigned long long>(neg) << kSign);
}

__device__ __forceinline__ unsigned long long crt_round_f64(
    const unsigned (&mag)[kWords], bool neg, int e_fix) {
  return crt_round<53, 1023, 0x7FF>(mag, neg, e_fix);
}

}  // namespace
}  // namespace gm8
