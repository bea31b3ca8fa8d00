// The CRT contraction and its fold: out = Y[nd] + sum_{d<nd} Y[d] per
// element, Y[d] = sum_j wc[d][j] rc_j over the element's residues
// (crt_mma.cuh), in the variants of scripts/probe_mxu_crt.py:
//   full     rc_j = r_j ^ 0x80 (uint8 residues, centred), contraction, fold
//   nodot    the sum of the centred residues (no contraction)
//   dotonly  int8 input (m/bm, L*bm, n), block i holding rows i*bm.. of
//            every modulus, modulus-major; no centring
//   noxor    int8 input (L, m, n), no centring
//
// Replaces: the Pallas kernels of scripts/probe_mxu_crt.py _build (:38, its
// calls :60 and :100): Y = W' R per (bm, bn) block on the TPU's matrix
// unit, W' the block-diagonal ((nd+1) bm, L bm) form.
// Bound on the H100: device-memory bytes, L read and 4 written an element
// (0.36 ms at 8192^2, 14 moduli); the MMAs (3 n-tiles x 16 x 8 x 32 a 16
// elements) are far below the int8 peak.
// Design: a warp takes 32 consecutive elements at a time (a grid-stride
// loop), thread (g, t) loads one 32-bit word (elements 4g..4g+3) from each
// of its moduli 4t..4t+3 and 16+4t.., transposes the bytes into A
// fragments and runs two MMAs per n-tile against the compact table
// (crt_mma.cuh). The fold sums each D row (the digits) inside the thread,
// then across the quad's four lanes with two shuffles; lane t writes element
// 4g + t, so a warp stores 128 contiguous bytes. Ragged sizes (m n not a
// multiple of 4, or n for dotonly) take byte loads.
#include "common.cuh"
#include "crt_mma.cuh"

namespace {

using gm8::CrtMmaTable;
using gm8::kCrtTiles;
constexpr int kThreads = 256;

enum Variant { kFull = 0, kNoDot = 1, kDotOnly = 2, kNoXor = 3 };

// byte offset of modulus j of element e
template <int kVar>
__device__ __forceinline__ size_t offset(int j, size_t e, int L, int n,
                                         int bm, size_t mn) {
  if constexpr (kVar == kDotOnly) {
    const size_t row = e / n, col = e % n;
    const size_t i = row / bm, ii = row % bm;
    return ((i * L + j) * bm + ii) * n + col;
  } else {
    return static_cast<size_t>(j) * mn + e;
  }
}

// the 4 bytes of elements e0..e0+3 of modulus j (0 past L and past mn)
template <int kVar, bool kVec>
__device__ __forceinline__ unsigned load_word(const unsigned char* r, int j,
                                              size_t e0, int L, int n,
                                              int bm, size_t mn) {
  if (j >= L || e0 >= mn) return 0u;
  unsigned w;
  if constexpr (kVec) {
    w = __ldg(reinterpret_cast<const unsigned*>(
        r + offset<kVar>(j, e0, L, n, bm, mn)));
  } else {
    w = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (e0 + b < mn)
        w |= static_cast<unsigned>(__ldg(r + offset<kVar>(j, e0 + b, L, n,
                                                          bm, mn)))
             << (8 * b);
  }
  return (kVar == kFull || kVar == kNoDot) ? w ^ 0x80808080u : w;
}

template <int kVar, bool kVec>
__global__ void __launch_bounds__(kThreads)
mxu_crt_kernel(const unsigned char* __restrict__ r, int* __restrict__ out,
               int L, int n, int bm, size_t mn,
               const __grid_constant__ CrtMmaTable W) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned bf[kCrtTiles][2];
  if constexpr (kVar != kNoDot) gm8::crt_b_frags(W, bf);
  const size_t warps = static_cast<size_t>(gridDim.x) * (kThreads / 32);
  const size_t chunks = (mn + 31) / 32;
  for (size_t c = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       c < chunks; c += warps) {
    const size_t e0 = c * 32 + 4 * g;
    unsigned w[4], lo[4], hi[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = load_word<kVar, kVec>(r, 4 * t + i, e0, L, n, bm, mn);
    gm8::transpose4(w, lo);
    if (L > 16) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = load_word<kVar, kVec>(r, 16 + 4 * t + i, e0, L, n, bm, mn);
      gm8::transpose4(w, hi);
    }
    int s[4];
    if constexpr (kVar == kNoDot) {
#pragma unroll
      for (int e = 0; e < 4; ++e)  // signed bytes summed: dot with ones
        s[e] = __dp4a(static_cast<int>(hi[e]), 0x01010101,
                      __dp4a(static_cast<int>(lo[e]), 0x01010101, 0));
    } else {
      int d[2][kCrtTiles][4];
      gm8::crt_mma(lo, hi, bf, d);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        s[2 * p] = s[2 * p + 1] = 0;
#pragma unroll
        for (int q = 0; q < kCrtTiles; ++q) {
          s[2 * p] += d[p][q][0] + d[p][q][1];      // row g: element 2p
          s[2 * p + 1] += d[p][q][2] + d[p][q][3];  // row g+8: 2p + 1
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // the rest of each row: the quad's lanes
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 1);
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 2);
    }
    if (e0 + t < mn) out[e0 + t] = s[t];
  }
}

template <int kVar>
void launch(const unsigned char* r, int* out, int L, int m, int n, int bm,
            const CrtMmaTable& W, cudaStream_t s) {
  const size_t mn = static_cast<size_t>(m) * n;
  const bool vec = kVar == kDotOnly ? n % 4 == 0 : mn % 4 == 0;
  const size_t chunks = (mn + 31) / 32;
  const size_t want = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (vec)
    mxu_crt_kernel<kVar, true><<<blocks, kThreads, 0, s>>>(r, out, L, n, bm,
                                                           mn, W);
  else
    mxu_crt_kernel<kVar, false><<<blocks, kThreads, 0, s>>>(r, out, L, n,
                                                            bm, mn, W);
}

}  // namespace

// r: (L, m, n) residues (uint8 for full and nodot, int8 for noxor), or
// (m/bm, L*bm, n) int8 for dotonly; out: (m, n) int32; table: the
// CrtMmaTable of L on the host (hopper/probes.py crt_mma_table).
GM8_EXPORT int gm8_probe_mxu_crt(const void* r, void* out, const void* table,
                                 int L, int m, int n, int bm, int variant,
                                 void* stream) {
  if (L < 2 || L > gm8::kMaxModuli || m < 1 || n < 1 || bm < 1 ||
      variant < 0 || variant > kNoXor || (variant == kDotOnly && m % bm))
    return static_cast<int>(cudaErrorInvalidValue);
  CrtMmaTable W = *static_cast<const CrtMmaTable*>(table);
  auto rp = static_cast<const unsigned char*>(r);
  auto op = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: launch<kFull>(rp, op, L, m, n, bm, W, s); break;
    case kNoDot: launch<kNoDot>(rp, op, L, m, n, bm, W, s); break;
    case kDotOnly: launch<kDotOnly>(rp, op, L, m, n, bm, W, s); break;
    default: launch<kNoXor>(rp, op, L, m, n, bm, W, s); break;
  }
  return gm8::launch_status();
}
