// Accurate-mode operand statistics: the max biased exponent of each row
// (axis=1) or column (axis=0) of an f64 or f32 operand, and the round-up
// 7-bit magnitudes below it, ceil(|x| * 2^(s - (emax - bias))) in
// [0, 2^(s+1)] for the magnitude shift s: 5 on the real path (<= 64), 4 on
// the complex path, whose |Re| + |Im| sums (<= 32 + 32) must not wrap int8.
//
// Replaces: emax_pallas (gemmul8_tpu/pallas/kernels.py:333) and
// mag7_pallas (gemmul8_tpu/pallas/kernels.py:408), their F64Bits and f32
// forms.
// Bound on the H100: device-memory bytes. emax reads 8 bytes per element
// (4 for f32); mag7 reads 8 (4) and writes 1. At 8192^2 that is 0.54 GB
// and 0.60 GB per f64 operand (0.27 and 0.34 GB f32), about 0.16 and 0.18
// ms (0.08 and 0.10 ms) at 3.35 TB/s.
// Design: the max is order-independent, so any blocking gives the same
// bits. emax over rows: one 256-thread block per row, neighbouring threads
// on neighbouring elements. emax over columns (strided): as in
// fast_sft.cu's column kernel, a block takes 32 neighbouring columns so a
// warp reads 256 contiguous bytes of a row; the contraction axis is also
// split into 256-row pieces across blocks (more blocks in flight), which
// fold with atomicMax into an output the caller zero-fills (0 is the
// neutral element: exponents are >= 0). mag7 writes both operands K-major,
// (rows, ld) with ld = k rounded up to 16 and zero padding, which is the
// layout the magnitude GEMM (magmax.cu) reads without a transpose: for A
// that is its own layout (a thread turns 4 elements into one 4-byte word);
// for B (k, n) a block transposes a 64 x 64 tile through shared memory, so
// both the 8-byte reads (along n) and the 4-byte writes (along k)
// coalesce. The magnitude is computed on the 53-bit (f32: 24-bit)
// significand in one 64-bit word, so no shift reaches the width of its
// operand. The source word is a template parameter (src_word.cuh): the
// f32 forms read 4-byte words with the same blocks and tiles.
//
// gm8_mag7_fused computes both in one kernel and writes the same buffer.
// Replaces: mag7_fused_pallas (gemmul8_tpu/pallas/kernels.py:465), its
// F64Bits and f32 forms.
// Bound: the same bytes with the operand read once, 0.60 GB per f64
// operand at 8192^2 (0.34 GB f32), about 0.18 ms (0.10 ms). Design: the
// max must be complete before any magnitude of its row or column, so one
// block owns a row of A (256 threads) or a 32-column strip of B (32 x 16
// threads) and reads it twice: a row's second read hits L2, a strip's (2
// MB at 8192 in f64) mostly does not. The max is exact, so the outputs are
// the two-kernel pair's bits. Its f32 form reads 4-byte words with the
// same blocks and tiles, as the pair's f32 forms do.
#include "common.cuh"
#include "src_word.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColX = 32;      // emax over columns: columns per block
constexpr int kColY = 8;       // ... threads per column
constexpr int kColRows = 256;  // ... rows of the contraction axis per block
constexpr int kT = 64;         // mag7 over columns: 64 x 64 tile

// biased exponent of a nonzero element (1 for subnormals); 0 for +-0
template <typename Word>
__device__ __forceinline__ int exp_nonzero(Word bits) {
  const int e = gm8::Src<Word>::biased_exp(bits);
  return (bits << 1) == Word(0) ? 0 : max(e, 1);
}

// ceil(|x| * 2^(mag_shift - (emax - bias))) mod 256 (in [0, 2^(mag_shift
// + 1)] when emax is the max exponent of x's row or column)
template <typename Word>
__device__ __forceinline__ unsigned mag7_byte(Word bits, int emax,
                                              int mag_shift) {
  using S = gm8::Src<Word>;
  const int e = S::biased_exp(bits);
  const unsigned long long mant = S::mant(bits);
  const int u =
      min(max(emax + S::kStored - mag_shift - max(e, 1), 0), 63);
  const unsigned long long v = mant >> u;
  return static_cast<unsigned>(v + ((v << u) != mant ? 1ull : 0ull)) & 0xFFu;
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
emax_rows(const Word* __restrict__ x, int* __restrict__ out, int kdim) {
  __shared__ int sh[kThreads / 32];
  const Word* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  int e = 0;
#pragma unroll 4
  for (int k = threadIdx.x; k < kdim; k += kThreads)
    e = max(e, exp_nonzero(xr[k]));
  for (int o = 16; o > 0; o >>= 1) e = max(e, __shfl_xor_sync(~0u, e, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) e = max(e, sh[i]);
    out[blockIdx.x] = e;
  }
}

template <typename Word>
__global__ void __launch_bounds__(kColX * kColY)
emax_cols(const Word* __restrict__ x, int* __restrict__ out, int kdim,
          int cols) {
  __shared__ int sh[kColY][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColX + tx;
  const int r0 = static_cast<int>(blockIdx.y) * kColRows;
  const int r1 = min(r0 + kColRows, kdim);
  int e = 0;
  if (col < cols) {
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += kColY)
      e = max(e, exp_nonzero(x[static_cast<size_t>(r) * cols + col]));
  }
  sh[ty][tx] = e;
  __syncthreads();
  if (ty == 0 && col < cols) {
    for (int i = 1; i < kColY; ++i) e = max(e, sh[i][tx]);
    if (e > 0) atomicMax(&out[col], e);
  }
}

// A (rows, kdim) -> (rows, ld) magnitudes, one 4-byte word per thread
template <typename Word>
__global__ void __launch_bounds__(kThreads)
mag7_rows(const Word* __restrict__ x, const int* __restrict__ emax,
          unsigned* __restrict__ out, int rows, int kdim, int ld_words,
          int mag_shift) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= ld_words) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const Word* xr = x + static_cast<size_t>(row) * kdim;
    const int e = emax[row];
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * w + i;
      if (k < kdim) word |= mag7_byte(xr[k], e, mag_shift) << (8 * i);
    }
    out[static_cast<size_t>(row) * ld_words + w] = word;
  }
}

// B (kdim, cols) -> (cols, ld) magnitudes, K-major, through a 64 x 64 tile
template <typename Word>
__global__ void __launch_bounds__(kThreads)
mag7_cols(const Word* __restrict__ x, const int* __restrict__ emax,
          unsigned char* __restrict__ out, int kdim, int cols, int ld,
          int mag_shift) {
  // [column][k]; a row of 68 bytes keeps the byte stores of a warp (32
  // neighbouring columns, one k) on 32 different banks
  __shared__ __align__(16) unsigned char sm[kT][kT + 4];
  const int n0 = blockIdx.x * kT, k0 = blockIdx.y * kT;
  const int c = threadIdx.x & (kT - 1), r0 = threadIdx.x / kT;
  const int col = n0 + c;
  const int e = col < cols ? emax[col] : 0;
#pragma unroll 4
  for (int r = r0; r < kT; r += kThreads / kT) {
    const int k = k0 + r;
    const Word bits =
        col < cols && k < kdim ? x[static_cast<size_t>(k) * cols + col]
                               : Word(0);
    sm[c][r] = static_cast<unsigned char>(mag7_byte(bits, e, mag_shift));
  }
  __syncthreads();
  // kT columns x kT / 4 words of k; ld % 4 == 0, so a word past kdim is
  // padding (zeros) and a word at or past ld is skipped whole
#pragma unroll
  for (int i = 0; i < kT * kT / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int nr = idx / (kT / 4), w = idx % (kT / 4);
    const int nn = n0 + nr, k = k0 + 4 * w;
    if (nn < cols && k < ld)
      *reinterpret_cast<unsigned*>(out + static_cast<size_t>(nn) * ld + k) =
          *reinterpret_cast<const unsigned*>(&sm[nr][4 * w]);
  }
}

// ---- emax and mag7 fused (one kernel, one block per row or column strip) --

// A (rows, kdim): the row's max exponent, then its magnitudes as 4-byte
// words of the (rows, ld) buffer; the second read of the row (64 KB at k =
// 8192) comes from L2 right after the first
template <typename Word>
__global__ void __launch_bounds__(kThreads)
mag7_fused_rows(const Word* __restrict__ x, int* __restrict__ emax,
                unsigned* __restrict__ out, int kdim, int ld_words,
                int mag_shift) {
  __shared__ int sh[kThreads / 32];
  const Word* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  int e = 0;
#pragma unroll 4
  for (int k = threadIdx.x; k < kdim; k += kThreads)
    e = max(e, exp_nonzero(xr[k]));
  for (int o = 16; o > 0; o >>= 1) e = max(e, __shfl_xor_sync(~0u, e, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = e;
  __syncthreads();
  e = sh[0];
  for (int i = 1; i < kThreads / 32; ++i) e = max(e, sh[i]);
  if (threadIdx.x == 0) emax[blockIdx.x] = e;
  unsigned* orow = out + static_cast<size_t>(blockIdx.x) * ld_words;
  for (int w = threadIdx.x; w < ld_words; w += kThreads) {
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * w + i;
      if (k < kdim) word |= mag7_byte(xr[k], e, mag_shift) << (8 * i);
    }
    orow[w] = word;
  }
}

constexpr int kFusedColY = 16;  // threads per column of a kColX strip
constexpr int kFusedK = 128;    // k per transpose tile

// B (kdim, cols): a kColX-column strip's max exponents, then its magnitudes
// K-major into (cols, ld) through a kColX x kFusedK tile in shared memory.
// The strip (kdim x 256 bytes in f64) is read twice; at 8192^2 the strips
// of the blocks in flight exceed L2, so the second read mostly misses it
template <typename Word>
__global__ void __launch_bounds__(kColX * kFusedColY)
mag7_fused_cols(const Word* __restrict__ x, int* __restrict__ emax,
                unsigned char* __restrict__ out, int kdim, int cols, int ld,
                int mag_shift) {
  __shared__ int sh[kFusedColY][kColX];
  // [column][k]; a row of kFusedK + 4 bytes keeps the byte stores of a warp
  // (kColX neighbouring columns, one k) on different banks
  __shared__ __align__(16) unsigned char sm[kColX][kFusedK + 4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * kColX, col = n0 + tx;
  const bool valid = col < cols;
  int e = 0;
  if (valid) {
#pragma unroll 4
    for (int r = ty; r < kdim; r += kFusedColY)
      e = max(e, exp_nonzero(x[static_cast<size_t>(r) * cols + col]));
  }
  sh[ty][tx] = e;
  __syncthreads();
  e = 0;
  for (int i = 0; i < kFusedColY; ++i) e = max(e, sh[i][tx]);
  if (valid && ty == 0) emax[col] = e;
  const int tid = ty * kColX + tx;
  for (int k0 = 0; k0 < ld; k0 += kFusedK) {
#pragma unroll
    for (int i = 0; i < kFusedK / kFusedColY; ++i) {
      const int r = ty + i * kFusedColY, k = k0 + r;
      const Word bits =
          valid && k < kdim ? x[static_cast<size_t>(k) * cols + col]
                            : Word(0);
      sm[tx][r] = static_cast<unsigned char>(mag7_byte(bits, e, mag_shift));
    }
    __syncthreads();
    // kColX columns x kFusedK / 4 words of k; ld % 4 == 0, so a word past
    // kdim is padding (zeros) and a word at or past ld is skipped whole
#pragma unroll
    for (int i = 0; i < kColX * kFusedK / 4 / (kColX * kFusedColY); ++i) {
      const int idx = tid + i * kColX * kFusedColY;
      const int nr = idx / (kFusedK / 4), w = idx % (kFusedK / 4);
      const int nn = n0 + nr, k = k0 + 4 * w;
      if (nn < cols && k < ld)
        *reinterpret_cast<unsigned*>(out + static_cast<size_t>(nn) * ld + k) =
            *reinterpret_cast<const unsigned*>(&sm[nr][4 * w]);
    }
    __syncthreads();  // sm is rewritten by the next tile
  }
}

template <typename Word>
int emax_launch(const void* x, int* op, int rows, int kdim, int axis,
                cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  if (axis == 1) {
    emax_rows<Word><<<rows, kThreads, 0, s>>>(xp, op, kdim);
  } else {
    dim3 grid((rows + kColX - 1) / kColX, (kdim + kColRows - 1) / kColRows);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    emax_cols<Word><<<grid, dim3(kColX, kColY), 0, s>>>(xp, op, kdim, rows);
  }
  return gm8::launch_status();
}

template <typename Word>
int mag7_launch(const void* x, const int* ep, void* out, int rows, int kdim,
                int axis, int ld, int mag_shift, cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  if (axis == 1) {
    const int ld_words = ld / 4;
    dim3 grid((ld_words + kThreads - 1) / kThreads,
              rows < 65535 ? rows : 65535);
    mag7_rows<Word><<<grid, kThreads, 0, s>>>(
        xp, ep, static_cast<unsigned*>(out), rows, kdim, ld_words,
        mag_shift);
  } else {
    dim3 grid((rows + kT - 1) / kT, (ld + kT - 1) / kT);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    mag7_cols<Word><<<grid, kThreads, 0, s>>>(
        xp, ep, static_cast<unsigned char*>(out), kdim, rows, ld, mag_shift);
  }
  return gm8::launch_status();
}

template <typename Word>
void mag7_fused_launch(const void* x, int* ep, void* out, int rows, int kdim,
                       int axis, int ld, int mag_shift, cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  if (axis == 1) {
    mag7_fused_rows<Word><<<rows, kThreads, 0, s>>>(
        xp, ep, static_cast<unsigned*>(out), kdim, ld / 4, mag_shift);
  } else {
    mag7_fused_cols<Word><<<(rows + kColX - 1) / kColX,
                            dim3(kColX, kFusedColY), 0, s>>>(
        xp, ep, static_cast<unsigned char*>(out), kdim, rows, ld, mag_shift);
  }
}

}  // namespace

// x: (rows, kdim) for axis=1, (kdim, rows) for axis=0, f64 bits (f32 = 0)
// or f32 bits (f32 = 1). out: rows int32, zero-filled by the caller. kdim
// <= 65535 * 256.
GM8_EXPORT int gm8_emax(const void* x, void* out, int rows, int kdim,
                        int axis, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto op = static_cast<int*>(out);
  return f32 ? emax_launch<unsigned>(x, op, rows, kdim, axis, s)
             : emax_launch<unsigned long long>(x, op, rows, kdim, axis, s);
}

// x as for gm8_emax; emax: rows int32 (the max exponents); out: (rows, ld)
// int8 magnitudes, K-major for both axes, ld >= kdim, ld % 4 == 0, with
// zeros in [kdim, ld); mag_shift in [0, 6] (5 real, 4 complex).
GM8_EXPORT int gm8_mag7(const void* x, const void* emax, void* out,
                        int rows, int kdim, int axis, int ld, int mag_shift,
                        int f32, void* stream) {
  if (ld % 4 != 0 || ld < kdim || mag_shift < 0 || mag_shift > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto ep = static_cast<const int*>(emax);
  return f32 ? mag7_launch<unsigned>(x, ep, out, rows, kdim, axis, ld,
                                     mag_shift, s)
             : mag7_launch<unsigned long long>(x, ep, out, rows, kdim, axis,
                                               ld, mag_shift, s);
}

// emax and mag7 in one kernel. x as for gm8_emax (f32 = 0: f64 bits, 1:
// f32 bits); emax: rows int32 (written whole, no zero fill); out and its
// conditions as for gm8_mag7.
GM8_EXPORT int gm8_mag7_fused(const void* x, void* emax, void* out, int rows,
                              int kdim, int axis, int ld, int mag_shift,
                              int f32, void* stream) {
  if (ld % 4 != 0 || ld < kdim || mag_shift < 0 || mag_shift > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto ep = static_cast<int*>(emax);
  if (f32)
    mag7_fused_launch<unsigned>(x, ep, out, rows, kdim, axis, ld, mag_shift,
                                s);
  else
    mag7_fused_launch<unsigned long long>(x, ep, out, rows, kdim, axis, ld,
                                          mag_shift, s);
  return gm8::launch_status();
}
