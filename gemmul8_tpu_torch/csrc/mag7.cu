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
// for B (k, n) a block transposes a 32 x 32 tile (the launch entry's)
// through shared memory, so both the 8-byte reads (along n) and the 4-byte
// writes (along k) coalesce. The magnitude is computed on the 53-bit (f32:
// 24-bit) significand in one 64-bit word, so no shift reaches the width of
// its operand. The source word is a template parameter (src_word.cuh): the
// f32 forms read 4-byte words with the same blocks and tiles.
//
// gm8_mag7_fused computes both in one kernel and writes the same buffer.
// Replaces: mag7_fused_pallas (gemmul8_tpu/pallas/kernels.py:465), its
// F64Bits and f32 forms.
// Bound: the same bytes with the operand read once, 0.60 GB per f64
// operand at 8192^2 (0.34 GB f32), about 0.18 ms (0.10 ms). Design: a
// magnitude depends on its line's max, known only at the line's end; the
// kernel still reads each word once, by nested ceilings. A line is read in
// pieces, each piece's magnitudes taken below the running max exponent of
// what has been read (the piece included); at the line's end only the
// pieces taken below its final max are rewritten, byte by byte:
// ceil(ceil(y) / 2^d) = ceil(y / 2^d) for an integer d >= 0, and the
// shift's clamp at 63 gives 1 (0 for a zero) either way. One block owns a
// row of A (its bytes wait in shared memory for the rewrite) or a
// 32-column strip of B (its bytes go out K-major tile by tile; the rewrite
// reads back the block's own bytes). core/encode.py mag7_fused_chunked is
// the plain twin of this arithmetic. The outputs are the two-kernel pair's
// bits. The f32 form reads 4-byte words with the same blocks and tiles, 4
// a 16-byte load.
#include "common.cuh"
#include "src_word.cuh"

#if !defined(GM8_MAG_COL_STRIP) || !defined(GM8_MAG_COL_THREADS) || \
    !defined(GM8_MAG_COL_ROWS) || !defined(GM8_MAG_TILE) ||            \
    !defined(GM8_MAG_FUSED_STEPS) || !defined(GM8_MAG_FUSED_K)
#error "mag7.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

// The blocking below comes from the launch table (hopper/launch.py
// `Mag7Launch`); the max is order-independent and the magnitudes are
// elementwise, so none of it moves a bit.
constexpr int kThreads = 256;
// the column kernels' strip: emax's columns per block, and mag7_fused's
constexpr int kColX = GM8_MAG_COL_STRIP;
constexpr int kColY = GM8_MAG_COL_THREADS;  // emax over columns: threads
                                            // per column
constexpr int kColRows = GM8_MAG_COL_ROWS;  // ... rows of the contraction
                                            // axis per block
constexpr int kT = GM8_MAG_TILE;  // mag7 over columns: kT x kT tile
static_assert(kColX * kColY <= 1024 && kColY >= 1 && kColRows >= 1,
              "emax's column blocks: at most 1024 threads");
static_assert((kT & (kT - 1)) == 0 && kT <= kThreads &&
                  kT * kT / 4 % kThreads == 0,
              "mag7's tile: a power of two whose words the block divides");
static_assert(kT * (kT + 4) <= 49152,
              "mag7's tile: over the static shared memory of a block");

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

// B (kdim, cols) -> (cols, ld) magnitudes, K-major, through a kT x kT tile
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

// ---- emax and mag7 fused: the operand read once ---------------------------

// ceil(m / 2^d) of a magnitude byte m (0 <= m <= 2^(mag_shift + 1) <= 128)
// for d > 0: a magnitude taken below an exponent d binades under the line's
// max, brought down to it (m != 0 once d >= 8, where m / 2^d < 1)
__device__ __forceinline__ unsigned fix_byte(unsigned m, int d) {
  return d >= 8 ? (m != 0u) : (m + (1u << d) - 1u) >> d;
}

__device__ __forceinline__ unsigned fix_word(unsigned v, int d) {
  return gm8::pack4(fix_byte(v & 0xFFu, d), fix_byte((v >> 8) & 0xFFu, d),
                    fix_byte((v >> 16) & 0xFFu, d), fix_byte(v >> 24, d));
}

__device__ __forceinline__ uint4 fix16(uint4 v, int d) {
  return make_uint4(fix_word(v.x, d), fix_word(v.y, d), fix_word(v.z, d),
                    fix_word(v.w, d));
}

// the 16 bytes of a line at p from element k, zero at or past end (kPer =
// 16 / sizeof(Word) elements): one 16-byte load where they all lie before
// end and the address is aligned
template <typename Word, int kPer = 16 / static_cast<int>(sizeof(Word))>
__device__ __forceinline__ void load16(const Word* __restrict__ p, int k,
                                       int end, Word (&w)[kPer]) {
  const Word* q = p + k;
  if (k + kPer <= end && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
    if constexpr (kPer == 2) {
      w[0] = (static_cast<unsigned long long>(v.y) << 32) | v.x;
      w[1] = (static_cast<unsigned long long>(v.w) << 32) | v.z;
    } else {
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) w[i] = k + i < end ? __ldg(q + i) : Word(0);
  }
}

constexpr int kFusedU = GM8_MAG_FUSED_STEPS;  // rows: a warp's steps whose
                                             // loads go out together
static_assert(kFusedU >= 1, "a step or more in flight");

// A (rows, kdim) -> emax and the (rows, ld) magnitudes, the row read once.
// A warp's step is kStep elements, one 16-byte load a lane; warp w takes
// steps w, w + 8, ..., keeps the running max exponent e_run of the steps it
// has read (each step's own included) and takes the step's magnitudes
// below it into the row's bytes in shared memory, recording e_run per step.
// Each element's exponent is <= its step's e_run <= the row's max, so the
// byte is ceil(|x| 2^(s - (e_run - bias))) <= 2^(s+1), and ceil(ceil(y) /
// 2^d) = ceil(y / 2^d) brings it to the row's max: the 16-byte pieces of
// steps recorded below it are rewritten so (fix16) on their way out.
template <typename Word>
__global__ void __launch_bounds__(kThreads)
mag7_fused_rows(const Word* __restrict__ x, int* __restrict__ emax,
                unsigned char* __restrict__ out, int kdim, int ld,
                int mag_shift) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(Word));
  constexpr int kStep = 32 * kPer;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int sh[kWarps];
  const int nsteps = (ld + kStep - 1) / kStep;  // they cover [0, ld)
  unsigned char* const mag = dyn;               // nsteps * kStep bytes
  int* const e_step = reinterpret_cast<int*>(dyn + nsteps * kStep);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Word* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  int e_run = 0;
  for (int s0 = warp; s0 < nsteps; s0 += kFusedU * kWarps) {
    Word w[kFusedU][kPer];
#pragma unroll
    for (int u = 0; u < kFusedU; ++u)
      load16(xr, (s0 + u * kWarps) * kStep + lane * kPer, kdim, w[u]);
#pragma unroll
    for (int u = 0; u < kFusedU; ++u) {
      const int st = s0 + u * kWarps;
      if (st >= nsteps) break;
      int e = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) e = max(e, exp_nonzero(w[u][i]));
      e_run = max(e_run, __reduce_max_sync(~0u, e));
      unsigned bytes = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        bytes |= mag7_byte(w[u][i], e_run, mag_shift) << (8 * i);
      unsigned char* const dst = mag + st * kStep + lane * kPer;
      if constexpr (kPer == 2)
        *reinterpret_cast<unsigned short*>(dst) =
            static_cast<unsigned short>(bytes);
      else
        *reinterpret_cast<unsigned*>(dst) = bytes;
      if (lane == 0) e_step[st] = e_run;
    }
  }
  if (lane == 0) sh[warp] = e_run;
  __syncthreads();  // the warps' maxima, bytes and records
  int e = sh[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) e = max(e, sh[i]);
  if (threadIdx.x == 0) emax[blockIdx.x] = e;
  unsigned char* const orow = out + static_cast<size_t>(blockIdx.x) * ld;
  for (int p = threadIdx.x; p < ld / 16; p += kThreads) {
    uint4 v = *reinterpret_cast<const uint4*>(mag + 16 * p);
    const int d = e - e_step[16 * p / kStep];
    if (d > 0) v = fix16(v, d);
    *reinterpret_cast<uint4*>(orow + 16 * p) = v;
  }
}

constexpr int kFusedK = GM8_MAG_FUSED_K;  // columns: k per tile
constexpr int kFusedPieces = kFusedK / 16;  // a column's 16-byte pieces a
                                            // tile, one a thread
__host__ __device__ constexpr int log2_exact(int v) {
  return v == 1 ? 0 : 1 + log2_exact(v / 2);
}
constexpr int kPieceShift = log2_exact(kFusedPieces);
// the longest line the fused kernels take (tables.MAX_K): its bytes and
// records fit a block's shared memory
constexpr int kMaxLd = 1 << 17;
static_assert(kColX * kFusedK / 16 == kThreads, "one piece a thread");
static_assert(kFusedK % 16 == 0 && (kFusedPieces & (kFusedPieces - 1)) == 0,
              "a tile's column is a power of two of 16-byte pieces");
static_assert(kColX % 4 == 0 && kColX <= 64 && (kColX & (kColX - 1)) == 0,
              "a strip row is a power of two of lanes, 16 bytes a lane");
static_assert(kMaxLd / kFusedK * kColX * 2 + (kThreads / 32 + 1) * kColX * 4 +
                      kColX * (kFusedK + 4) <=
                  232448,
              "mag7_fused's columns: over the shared memory a block may opt "
              "into on sm_90");

// B (kdim, cols) -> emax and the (cols, ld) magnitudes, K-major, B read
// once. A block walks a kColX-column strip in tiles of kFusedK rows (16-byte
// loads, the next tile's in flight during this one), takes each tile's
// column maxima into the running max e_run of its columns and the tile's
// magnitudes below it, and writes them K-major at once through a transpose
// tile in shared memory (one 16-byte store a thread), recording e_run per
// (tile, column). After the strip's last tile its max is final: the tiles
// recorded below it are read back (from L2, this block's own bytes) and
// rewritten (fix16), as in the rows kernel.
template <typename Word>
__global__ void __launch_bounds__(kThreads)
mag7_fused_cols(const Word* __restrict__ x, int* __restrict__ emax,
                unsigned char* __restrict__ out, int kdim, int cols, int ld,
                int mag_shift) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(Word));  // columns a load
  constexpr int kLanes = kColX / kPer;        // threads across a strip row
  constexpr int kRowsPass = kThreads / kLanes;  // rows a pass of the block
  constexpr int kPass = kFusedK / kRowsPass;    // passes a tile
  constexpr int kWarps = kThreads / 32;
  constexpr int kRowBytes = kFusedK + 4;  // a transpose row: 33 words at
                                          // k 128
  static_assert(kFusedK % kRowsPass == 0, "whole passes a tile");
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned short* const e_rec = reinterpret_cast<unsigned short*>(dyn);
  __shared__ int red[kWarps][kColX];
  __shared__ __align__(16) unsigned sm[kColX * kRowBytes / 4];
  __shared__ int e_fin[kColX];
  unsigned char* const smb = reinterpret_cast<unsigned char*>(sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = kPer * (tid % kLanes);  // the thread's first column
  const int rb = tid / kLanes;           // its row in each pass
  const int n0 = blockIdx.x * kColX, end = cols - n0;
  const int ntiles = (ld + kFusedK - 1) / kFusedK;
  const Word* const xs = x + n0;
  int e_run[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) e_run[c] = 0;
  Word w[kPass][kPer], nw[kPass][kPer];
#pragma unroll
  for (int p = 0; p < kPass; ++p) {
    const int r = rb + p * kRowsPass;
    if (r < kdim) {
      load16(xs + static_cast<size_t>(r) * cols, c0, end, w[p]);
    } else {
#pragma unroll
      for (int c = 0; c < kPer; ++c) w[p][c] = Word(0);
    }
  }
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kFusedK;
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int r = k0 + kFusedK + rb + p * kRowsPass;
      if (r < kdim) {
        load16(xs + static_cast<size_t>(r) * cols, c0, end, nw[p]);
      } else {
#pragma unroll
        for (int c = 0; c < kPer; ++c) nw[p][c] = Word(0);
      }
    }
    // the tile's column maxima: the thread's rows, the lanes of its
    // columns, the warps
    int e[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      e[c] = 0;
#pragma unroll
      for (int p = 0; p < kPass; ++p) e[c] = max(e[c], exp_nonzero(w[p][c]));
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1)
        e[c] = max(e[c], __shfl_xor_sync(~0u, e[c], o));
    }
    if (lane < kLanes) {
#pragma unroll
      for (int c = 0; c < kPer; ++c) red[warp][c0 + c] = e[c];
    }
    __syncthreads();  // red; every thread is done with the last tile's sm
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      int m = red[0][c0 + c];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) m = max(m, red[i][c0 + c]);
      e_run[c] = max(e_run[c], m);
      if (rb == 0) e_rec[t * kColX + c0 + c] = static_cast<unsigned short>(
          e_run[c]);
    }
#pragma unroll
    for (int p = 0; p < kPass; ++p)
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        smb[(c0 + c) * kRowBytes + rb + p * kRowsPass] =
            static_cast<unsigned char>(mag7_byte(w[p][c], e_run[c],
                                                 mag_shift));
    __syncthreads();  // sm
    {
      const int c = tid >> kPieceShift, j = tid & (kFusedPieces - 1);
      const int n = n0 + c, k = k0 + 16 * j;
      if (n < cols && k < ld) {
        const unsigned* row = sm + c * (kRowBytes / 4) + 4 * j;
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(n) * ld + k) =
            make_uint4(row[0], row[1], row[2], row[3]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPass; ++p)
#pragma unroll
      for (int c = 0; c < kPer; ++c) w[p][c] = nw[p][c];
  }
  if (rb == 0) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      e_fin[c0 + c] = e_run[c];
      if (c0 + c < end) emax[n0 + c0 + c] = e_run[c];
    }
  }
  __syncthreads();  // e_fin; the strip's bytes are visible to the block
  for (int p = tid; p < ntiles * kColX * (kFusedK / 16); p += kThreads) {
    const int t = p / (kColX * (kFusedK / 16));
    const int c = (p / (kFusedK / 16)) % kColX, j = p % (kFusedK / 16);
    const int d = e_fin[c] - e_rec[t * kColX + c];
    const int k = t * kFusedK + 16 * j;
    if (d > 0 && c < end && k < ld) {
      uint4* q = reinterpret_cast<uint4*>(
          out + static_cast<size_t>(n0 + c) * ld + k);
      *q = fix16(__ldcg(q), d);
    }
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
int mag7_fused_launch(const void* x, int* ep, void* out, int rows, int kdim,
                      int axis, int ld, int mag_shift, cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  auto op = static_cast<unsigned char*>(out);
  constexpr int kStep = 32 * 16 / static_cast<int>(sizeof(Word));
  if (axis == 1) {
    const int nsteps = (ld + kStep - 1) / kStep;
    const int bytes = nsteps * (kStep + 4);
    cudaFuncSetAttribute(mag7_fused_rows<Word>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxLd / kStep * (kStep + 4));
    mag7_fused_rows<Word><<<rows, kThreads, bytes, s>>>(xp, ep, op, kdim, ld,
                                                        mag_shift);
  } else {
    const int bytes = (ld + kFusedK - 1) / kFusedK * kColX * 2;
    cudaFuncSetAttribute(mag7_fused_cols<Word>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxLd / kFusedK * kColX * 2);
    mag7_fused_cols<Word><<<(rows + kColX - 1) / kColX, kThreads, bytes,
                            s>>>(xp, ep, op, kdim, rows, ld, mag_shift);
  }
  return gm8::launch_status();
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

// emax and mag7 in one kernel, x read once. x as for gm8_emax (f32 = 0:
// f64 bits, 1: f32 bits); emax: rows int32 (written whole, no zero fill);
// out: (rows, ld) int8 magnitudes, K-major for both axes, ld >= kdim, ld %
// 16 == 0, ld <= 2^17, zeros in [kdim, ld); mag_shift in [0, 6].
GM8_EXPORT int gm8_mag7_fused(const void* x, void* emax, void* out, int rows,
                              int kdim, int axis, int ld, int mag_shift,
                              int f32, void* stream) {
  if (ld % 16 != 0 || ld < kdim || ld > kMaxLd || mag_shift < 0 ||
      mag_shift > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto ep = static_cast<int*>(emax);
  return f32 ? mag7_fused_launch<unsigned>(x, ep, out, rows, kdim, axis, ld,
                                           mag_shift, s)
             : mag7_fused_launch<unsigned long long>(x, ep, out, rows, kdim,
                                                     axis, ld, mag_shift, s);
}
