// The reconstruct kernel's tail (reconstruct.cu; also the pipeline's rider,
// matmul_rider.cu, and matmul_reconstruct.cu), from the CRT sum X to the
// rounded output word, on kW 32-bit words (4 where X < 2^128, else 6):
//   limbs_to_words  X from 16-bit limbs (each >= 0 and < 2^29, canonical
//                   or not), the carries propagated once
//   center_rn       X -> |centered(X mod M)| and its sign
//   round_rn        RNE( +-magnitude * 2^e_fix ) as f64 or f32 bits
// crt.cuh keeps the older tail matmul_crt.cu runs; both give the
// plain version's bits (every step is exact).
//
// The quotient is estimated ROUNDED TO NEAREST: q = fl(fl(X) / M) in f64,
// t = rint(q), Y = X - t M in one multiply-subtract pass (two's complement
// over the words). For X < 2^13 M (a sum of residues: X < 256 L M) q is
// within 2^-37 of X / M (q carries kW + 1 roundings of 2^-53: X's 64-bit
// word pairs converted and added, 1/M, the product), so where |q - t| <
// 1/2 - 2^-30 the true X / M - t lies strictly inside (-1/2, 1/2): Y is
// already the centred value, its sign is the top word's, and one
// conditional negate gives the magnitude. Only where q lies within 2^-30
// of a half-integer (about one element in 2^29) does a
// branch compare Y with M / 2 exactly and add or subtract M once. crt.cuh's
// crt_center estimates low and takes four passes: two conditional
// subtractions, the centring compare and the negate.
//
// The rounding takes the highest nonzero word and the two below it by a
// static scan (no register array indexed at run time, which would live in
// local memory), normalises them with funnel shifts into a 64-bit H whose
// bit 63 is the msb, and rounds H once to the output's significand (the
// FPU's conversion where the result is normal); the bits below H only feed
// the sticky bit.
#pragma once

#include "common.cuh"
#include "moduli.cuh"

namespace gm8 {
namespace {

template <int kW>
__device__ __forceinline__ void limbs_to_words(const int (&limb)[2 * kW],
                                               unsigned (&x)[kW]) {
  unsigned long long carry = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const unsigned long long s =
        carry + static_cast<unsigned>(limb[2 * w]) +
        (static_cast<unsigned long long>(static_cast<unsigned>(
             limb[2 * w + 1])) << 16);
    x[w] = static_cast<unsigned>(s);
    carry = s >> 32;
  }
}

// y (two's complement, kW words) += sgn * c (c: nonnegative words of a
// CrtTable, sgn = +1 or -1)
template <int kW>
__device__ __forceinline__ void add_words(unsigned (&y)[kW],
                                          const unsigned* c, int sgn) {
  long long b = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const long long v = static_cast<long long>(y[w]) + sgn * static_cast<
        long long>(c[w]) + b;
    y[w] = static_cast<unsigned>(v);
    b = v >> 32;
  }
}

// whether the two's complement y is below the nonnegative c
template <int kW>
__device__ __forceinline__ bool below(const unsigned (&y)[kW],
                                      const unsigned* c) {
  long long b = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w)
    b = (static_cast<long long>(y[w]) - c[w] + b) >> 32;
  // the borrow out of the top word, with y's sign word beyond it
  return static_cast<int>(y[kW - 1]) < 0 ? true : b < 0;
}

// mag = |centered(X mod M)|, returns whether it is negative. M must fit
// kW - 1 words and a bit (|Y| < 2^(32 kW - 1)).
template <int kW>
__device__ __forceinline__ bool center_rn(const unsigned (&x)[kW],
                                          const CrtTable& T,
                                          unsigned (&mag)[kW]) {
  // X in f64 from its 64-bit word pairs, the highest first: each pair
  // converted (one rounding), scaled by 2^64 (exact), added (one rounding)
  double xd = 0.0;
#pragma unroll
  for (int w = kW - 2; w >= 0; w -= 2)
    xd = __dadd_rn(__dmul_rn(xd, 0x1p64),
                   __ull2double_rn(
                       (static_cast<unsigned long long>(x[w + 1]) << 32) |
                       x[w]));
  const double q = __dmul_rn(xd, T.rinv);
  const double tq = rint(q);
  const unsigned t = static_cast<unsigned>(tq);  // X / M < 2^13
  unsigned y[kW];
  long long b = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const long long v =
        static_cast<long long>(x[w]) -
        static_cast<long long>(static_cast<unsigned long long>(t) *
                               T.big_m[w]) + b;
    y[w] = static_cast<unsigned>(v);
    b = v >> 32;
  }
  if (fabs(__dsub_rn(q, tq)) >= 0.5 - 0x1p-30) {
    // Y is within one M of the centred value: bring it into
    // [half1 - M, half1 - 1] = (-M/2, M/2]
    if (!below(y, T.half1)) {
      add_words(y, T.big_m, -1);
    } else {
      unsigned z[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) z[w] = y[w];
      add_words(z, T.big_m, 1);
      if (below(z, T.half1)) {
#pragma unroll
        for (int w = 0; w < kW; ++w) y[w] = z[w];
      }
    }
  }
  const bool neg = static_cast<int>(y[kW - 1]) < 0;
  const unsigned s = neg ? 0xFFFFFFFFu : 0u;
  unsigned long long c = neg ? 1u : 0u;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const unsigned long long v = static_cast<unsigned long long>(y[w] ^ s) + c;
    mag[w] = static_cast<unsigned>(v);
    c = v >> 32;
  }
  return neg;
}

// RNE( (-1)^neg * mag * 2^e_fix ) into an IEEE word of kMant significand
// bits (53: f64, 24: f32), exponent bias kBias and all-ones exponent
// kExpMax; subnormals, zero and overflow to inf included, rounded once
// straight from the integer. H, the 64 bits from the msb down, with any
// lower nonzero bit folded into its last bit (below the rounding bit of
// either output), is converted by the FPU with one rounding to nearest
// even; where the result is normal its exponent is then moved by an exact
// integer add. A subnormal or overflowing result takes the integer path.
template <int kW, int kMant, int kBias, int kExpMax>
__device__ __forceinline__ unsigned long long round_rn(
    const unsigned (&mag)[kW], bool neg, int e_fix) {
  constexpr int kSign = kMant == 53 ? 63 : 31;
  int top = -1;
  unsigned a = 0, b = 0, c = 0;
  bool low = false;
#pragma unroll
  for (int w = kW - 1; w >= 0; --w) {
    const unsigned v = mag[w];
    if (top < 0) {
      if (v) {
        top = w;
        a = v;
      }
    } else if (w == top - 1) {
      b = v;
    } else if (w == top - 2) {
      c = v;
    } else {
      low |= v != 0;
    }
  }
  const unsigned long long sign = static_cast<unsigned long long>(neg)
                                  << kSign;
  if (top < 0) return sign;
  const int s = __clz(a);
  const int p = 32 * top + 31 - s;  // the msb's position
  const unsigned long long H =
      (static_cast<unsigned long long>(__funnelshift_l(b, a, s)) << 32) |
      __funnelshift_l(c, b, s);
  low |= (c << s) != 0;
  const int eb = p + e_fix + kBias;
  if (eb >= 1 && eb < kExpMax - 1) {
    // H = mant * 2^(p - 63) exactly; the converted word's exponent field
    // is kBias + 63 (or + 64 after a round-up), moved by p - 63 + e_fix
    const unsigned long long h = H | (low ? 1ull : 0ull);
    const long long k = p - 63 + e_fix;
    if constexpr (kMant == 53)
      return sign | static_cast<unsigned long long>(
                        __double_as_longlong(__ull2double_rn(h)) +
                        k * (1ll << 52));
    else
      return sign | static_cast<unsigned>(
                        __float_as_int(__ull2float_rn(h)) +
                        static_cast<int>(k) * (1 << 23));
  }
  if (eb >= kExpMax)
    return sign | (static_cast<unsigned long long>(kExpMax) << (kMant - 1));
  // the bits of H dropped: 64 - kMant, more below the normal range
  const int S = 64 - kMant + (eb < 1 ? 1 - eb : 0);
  unsigned long long mant = 0;
  bool rbit = false, sticky = true;
  if (S <= 64) {
    mant = S < 64 ? H >> S : 0;
    rbit = (H >> (S - 1)) & 1;
    sticky = (H << (65 - S)) != 0 || low;
  }
  mant += (rbit && (sticky || (mant & 1))) ? 1 : 0;
  // normal: the mantissa with its implicit bit added to (eb - 1) << (kMant
  // - 1) carries a round-up overflow into the exponent (and to inf);
  // subnormal: a round-up into bit kMant - 1 is the smallest normal
  const unsigned long long bits =
      eb < 1 ? mant
             : (static_cast<unsigned long long>(eb - 1) << (kMant - 1)) +
                   mant;
  return sign | bits;
}

// the output word: f64 bits (unsigned long long) or f32 bits (unsigned)
template <typename Word, int kW>
__device__ __forceinline__ Word round_word_rn(const unsigned (&mag)[kW],
                                              bool neg, int e_fix) {
  if constexpr (sizeof(Word) == 8)
    return round_rn<kW, 53, 1023, 0x7FF>(mag, neg, e_fix);
  else
    return static_cast<unsigned>(round_rn<kW, 24, 127, 0xFF>(mag, neg,
                                                            e_fix));
}

}  // namespace
}  // namespace gm8
