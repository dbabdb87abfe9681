// Fused logarithmic-posit MAC matmul: C[M,N] = sum_k va*vb - sum_k ra*rb.
//
// Replaces the TPU kernel repro/kernels/logmac.py:136 _logmac_kernel
// (pl.pallas_call at :168, entry logmac :150).  Inputs are posit patterns
// (uint32 words, low N bits valid), the output is the f32 "quire" value.
// Every word is decoded into the (val, rem) ILM planes euler::decode_planes
// gives, the counterpart of decode_planes_raw.  No float atomics: two
// launches on the same input give the same bits.  The wrapper
// (kernels/logmac.py: _plan) picks one of four kernels from M and the
// format alone, three here and logmac_pieces.cu's bf16-piece tensor-core
// kernel (M > 32, P32 L-21b and L-22b and the P16 variants but L-21b);
// above 32 rows the K-split follows N, K and the format alone:
//
// * logmac_small_kernel (M <= 32: decode steps, short prefills).  Here the
//   work is the K x N weight words: 4 bytes each (3.35 TB/s) against their
//   decode into two planes and only 4*M FMAs a word, so the decode's
//   integer work or the words' bytes bound it, not the FMAs.  It decodes
//   each B word exactly once and feeds it to all M rows.  A block owns
//   SM_BN = 128 columns and one K-split; its 8 warps are WN along N and WK
//   along K.  A thread owns CPT consecutive columns (4, 2 or 1 as M grows,
//   so that its MR x CPT x 2 accumulators stay at <= 64 registers) and
//   loads their words with one 16/8/4-byte load per K row, coalesced
//   across the warp, U rows at a time with the next U in flight.  A's rows
//   of the K-slice are decoded once per block into shared memory as two
//   planes, [k][MR], read as float4 broadcasts.  The served P16 words
//   decode through a 4096-entry table in shared memory and P8 through a
//   256-entry one (both built by euler::decode_planes; logmac_decode.cuh),
//   which leaves them bound by their bytes; P32 L-21b decodes
//   arithmetically with its knobs as constants, any other format with its
//   knobs read at run time.  The WK warp groups' partial sums are added in
//   a fixed order through shared memory; with S K-splits each block writes
//   its v and r partials to a [S, 2, M, N] scratch and logmac_splitk_reduce
//   adds them in split order and subtracts r from v, as the reference
//   does; with S = 1 the block writes C directly.  S is picked so that the
//   grid is one wave of two blocks per SM.
// * logmac_mma_kernel (M > 32, formats whose planes are exact in fp16:
//   kernels/logmac.py: mma_key, P8 and P16 L-21b).  A nonzero val plane is
//   +-2^(scale - m) * j with j < 2^(m + 1) (m kept fraction bits) and the
//   rem plane keeps a subset of its bits; P16 L-21b has m = 8 and scales
//   in [-6, 5] (the rem plane's lowest bit 2^-16, an fp16 subnormal), P8
//   L-21b m = 4 and scales in [-2, 1]: every plane value is an fp16 value,
//   and the product of two, at most 9 x 9 = 18 bits, is exact in an f32
//   accumulator.  So mma.sync m16n8k16 (fp16 in, f32 accumulate) computes
//   the very products of the f32 kernels; only the order of the f32 sums
//   differs, within chip_smoke's per-element bound, and at K = 1 the
//   result is exact (va*vb - ra*rb of such planes fits an f32).  A block
//   owns 128 columns and 64 or 128 rows (8 warps, 2 x 4, each a 32 x 32 or
//   64 x 32 warp tile) and one K-split.  Its raw words come in through a
//   ring of MMA_STAGES shared-memory stages of 16 K rows by cp.async
//   (16-byte copies where the bases and rows allow, else 4-byte), the copy
//   of stage s+2 in flight while stage s+1 is decoded and stage s is
//   multiplied (two decoded buffers, one barrier per stage).  Each stage is
//   decoded once per block through an fp16 (val, rem) table in shared
//   memory (the P16 table converted from logmac_table16's, the P8 one built
//   per block) into A rows [va | ra] and B rows [vb ; -rb], read by
//   ldmatrix (.trans for B); both planes share one accumulator, a product
//   of depth 2K, which halves the accumulator registers (two blocks an SM,
//   105 KB of shared memory each).  Split-K partials go to an [S, rows,
//   N] scratch that logmac_mma_reduce (mma_sync.cuh) adds in split order;
//   the plan aims one row tile at one wave of two blocks per SM, and every
//   row tile of a taller call runs that same split, so a row's bits do
//   not depend on M.  What bounds it: at the
//   fp16 rate the products are far below the bytes (4MNK / 989 TFLOP/s is
//   0.011 ms at M=128 [2304, 9216] against 0.027 ms of words at 3.35 TB/s),
//   and per stage the shared-memory traffic of the decode (table lookups
//   that conflict on random words, the raw words read and the planes
//   written) and of ldmatrix sets the pace, with mma.sync, not wgmma.
// * logmac_kernel (M > 32, formats both tensor-core kernels refuse: the
//   unbounded P32 variants, whose planes reach below what bf16 pieces
//   hold, and P32 without truncation, six pieces a word): the 64x64 f32
//   shared-memory tile kernel on CUDA cores (two fmaf per plane pair, at
//   most 67 TFLOP/s); each element of an A or B tile is decoded
//   arithmetically once per tile, synchronous loads, no K-split.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include "logmac_decode.cuh"
#include "mma_sync.cuh"

#define BM 64
#define BN 64
#define BK 16

__global__ void __launch_bounds__(256)
logmac_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
              float* __restrict__ C, int M, int N, int K, euler::Posit pc,
              euler::Planes pl, int sub_rem) {
  __shared__ float As_v[BK][BM];
  __shared__ float As_r[BK][BM];
  __shared__ float Bs_v[BK][BN];
  __shared__ float Bs_r[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc_v[4][4], acc_r[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_v[i][j] = acc_r[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      int e = tid + it * 256;
      int m = e / BK, kk = e % BK;
      int gm = row0 + m, gk = k0 + kk;
      uint32_t p = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0u;
      float v, r;
      euler::decode_planes(p, pc, pl, &v, &r);
      As_v[kk][m] = v;
      As_r[kk][m] = r;
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      int e = tid + it * 256;
      int kk = e / BN, n = e % BN;
      int gk = k0 + kk, gn = col0 + n;
      uint32_t p = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0u;
      float v, r;
      euler::decode_planes(p, pc, pl, &v, &r);
      Bs_v[kk][n] = v;
      Bs_r[kk][n] = r;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], ar[4], bv[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As_v[kk][ty + 16 * i];
        ar[i] = As_r[kk][ty + 16 * i];
        bv[i] = Bs_v[kk][tx + 16 * i];
        br[i] = Bs_r[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_v[i][j] = fmaf(av[i], bv[j], acc_v[i][j]);
          acc_r[i][j] = fmaf(ar[i], br[j], acc_r[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = col0 + tx + 16 * j;
      if (gn < N)
        C[(size_t)gm * N + gn] = sub_rem ? acc_v[i][j] - acc_r[i][j]
                                         : acc_v[i][j];
    }
  }
}

// ---- the small-M kernel --------------------------------------------------

constexpr int SM_THREADS = 256;
constexpr int SM_BN = 128;
// 64 KB of dynamic shared memory: the A chunk's two planes, then the warp
// groups' partial sums (FMT_TABLE16's 32 KB table follows them)
constexpr int SM_FLOATS = 16384;

template <int MR>
struct SmallShape {
  static constexpr int CPT = MR <= 8 ? 4 : (MR == 16 ? 2 : 1);
  static constexpr int WN = SM_BN / (32 * CPT);        // 1, 2, 4
  static constexpr int WK = (SM_THREADS / 32) / WN;    // 8, 4, 2
  static constexpr int KC = SM_FLOATS / (2 * MR);      // A rows per chunk
  static constexpr int U = MR <= 4 ? 4 : 2;            // B rows per group
  static_assert(WK * 2 * MR * SM_BN <= SM_FLOATS, "partials fit");
};

// The (val, rem) planes of the positive 16-bit bodies (i << 3) | 1
__global__ void logmac_table16_kernel(float2* __restrict__ t, euler::Posit pc,
                                      euler::Planes pl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= TABLE16) return;
  float v, r;
  euler::decode_planes((uint32_t)((i << 3) | 1), pc, pl, &v, &r);
  t[i] = make_float2(v, r);
}

template <int CPT, bool VEC>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ row,
                                           int col, int N, uint32_t* w) {
  if constexpr (VEC && CPT == 4) {
    uint4 q = __ldg(reinterpret_cast<const uint4*>(row + col));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (VEC && CPT == 2) {
    uint2 q = __ldg(reinterpret_cast<const uint2*>(row + col));
    w[0] = q.x; w[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      w[c] = col + c < N ? __ldg(row + col + c) : 0u;
  }
}

// The words of rows kk0, kk0 + WK, ... (U of them) of a thread's columns;
// rows past kc read as the zero word.
template <int U, int CPT, bool VEC, int WK>
__device__ __forceinline__ void load_group(const uint32_t* __restrict__ brow,
                                           int kk0, int kc, int col, int N,
                                           uint32_t (&w)[U][CPT]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kk = kk0 + u * WK;
    if (kk < kc) {
      load_words<CPT, VEC>(brow + (size_t)kk * N, col, N, w[u]);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) w[u][c] = 0u;
    }
  }
}

template <int MR, bool VEC, int FMT>
__global__ void __launch_bounds__(SM_THREADS, 2)
logmac_small_kernel(const uint32_t* __restrict__ A,
                    const uint32_t* __restrict__ B, float* __restrict__ C,
                    float* __restrict__ part,
                    const float2* __restrict__ tab16, int M, int N, int K,
                    int ks, euler::Posit pc, euler::Planes pl, int sub_rem) {
  using S = SmallShape<MR>;
  constexpr int CPT = S::CPT, WN = S::WN, WK = S::WK, KC = S::KC, U = S::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr bool TAB = FMT == FMT_TABLE8;
  __shared__ float2 tab8[TAB ? 256 : 1];
  // FMT_TABLE16's table follows the A chunk / partials in dynamic memory
  float2* tab = TAB ? tab8 : reinterpret_cast<float2*>(sm + SM_FLOATS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int lcol = (wn * 32 + lane) * CPT;          // column in the tile
  const int col = blockIdx.x * SM_BN + lcol;
  const int split = blockIdx.y;
  const int kbeg = split * ks;
  const int kend = min(K, kbeg + ks);
  // B rows in groups of U; the next group's words are loaded while this
  // group is decoded, so 2U rows a warp are in flight.  The first group is
  // asked for before the table and A's planes are ready.
  uint32_t cur[U][CPT], nxt[U][CPT];
  if (col < N && kbeg < kend)
    load_group<U, CPT, VEC, WK>(B + (size_t)kbeg * N, wk,
                                min(KC, kend - kbeg), col, N, cur);
  if constexpr (TAB) {
    float v, r;
    euler::decode_planes((uint32_t)tid, pc, pl, &v, &r);
    tab8[tid] = make_float2(v, r);
  } else if constexpr (FMT == FMT_TABLE16) {
    const float4* src = reinterpret_cast<const float4*>(tab16);
    float4* dst = reinterpret_cast<float4*>(tab);
    for (int i = tid; i < TABLE16 / 2; i += SM_THREADS) dst[i] = src[i];
  }

  float acc_v[MR][CPT], acc_r[MR][CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_v[m][c] = acc_r[m][c] = 0.0f;

  float* av_s = sm;              // [KC][MR]
  float* ar_s = sm + KC * MR;    // [KC][MR]
  for (int c0 = kbeg; c0 < kend; c0 += KC) {
    const int kc = min(KC, kend - c0);
    const uint32_t* brow = B + (size_t)c0 * N;
    if (c0 != kbeg && col < N)
      load_group<U, CPT, VEC, WK>(brow, wk, kc, col, N, cur);
    __syncthreads();  // the table is built; the last chunk is read
    for (int e = tid; e < MR * kc; e += SM_THREADS) {
      const int m = e / kc, kk = e % kc;
      const uint32_t w = m < M ? A[(size_t)m * K + c0 + kk] : 0u;
      float v, r;
      decode_word<FMT>(w, pc, pl, tab, v, r);
      av_s[kk * MR + m] = v;
      ar_s[kk * MR + m] = r;
    }
    __syncthreads();
    if (col < N) {
      for (int kk0 = wk; kk0 < kc; kk0 += U * WK) {
        if (kk0 + U * WK < kc)
          load_group<U, CPT, VEC, WK>(brow, kk0 + U * WK, kc, col, N, nxt);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = kk0 + u * WK;
          if (kk >= kc) break;
          float bv[CPT], br[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            decode_word<FMT>(cur[u][c], pc, pl, tab, bv[c], br[c]);
#pragma unroll
          for (int m4 = 0; m4 < MR; m4 += 4) {
            const float4 a =
                *reinterpret_cast<const float4*>(av_s + kk * MR + m4);
            const float4 b =
                *reinterpret_cast<const float4*>(ar_s + kk * MR + m4);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float ar[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                acc_v[m4 + i][c] = fmaf(av[i], bv[c], acc_v[m4 + i][c]);
                acc_r[m4 + i][c] = fmaf(ar[i], br[c], acc_r[m4 + i][c]);
              }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int c = 0; c < CPT; ++c) cur[u][c] = nxt[u][c];
      }
    }
  }
  __syncthreads();
  // the WK warp groups' partial sums, [WK][2][MR][SM_BN], added in wk order
  float* red = sm;
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      red[((wk * 2 + 0) * MR + m) * SM_BN + lcol + c] = acc_v[m][c];
      red[((wk * 2 + 1) * MR + m) * SM_BN + lcol + c] = acc_r[m][c];
    }
  __syncthreads();
  for (int e = tid; e < MR * SM_BN; e += SM_THREADS) {
    const int m = e / SM_BN, n = e % SM_BN;
    const int gn = blockIdx.x * SM_BN + n;
    if (m >= M || gn >= N) continue;
    float sv = 0.0f, sr = 0.0f;
#pragma unroll
    for (int q = 0; q < WK; ++q) {
      sv += red[((q * 2 + 0) * MR + m) * SM_BN + n];
      sr += red[((q * 2 + 1) * MR + m) * SM_BN + n];
    }
    if (gridDim.y == 1) {
      C[(size_t)m * N + gn] = sub_rem ? sv - sr : sv;
    } else {
      const size_t mn = (size_t)M * N, i = (size_t)m * N + gn;
      part[(size_t)(split * 2 + 0) * mn + i] = sv;
      part[(size_t)(split * 2 + 1) * mn + i] = sr;
    }
  }
}

// C = sum_s v_s - sum_s r_s over the [S, 2, M, N] partials, in split order
__global__ void logmac_splitk_reduce(const float* __restrict__ part,
                                     float* __restrict__ C, long long mn,
                                     int S, int sub_rem) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sv = 0.0f, sr = 0.0f;
  for (int s = 0; s < S; ++s) {
    sv += part[(2 * s + 0) * mn + i];
    sr += part[(2 * s + 1) * mn + i];
  }
  C[i] = sub_rem ? sv - sr : sv;
}

template <int MR, bool VEC, int FMT>
static int launch_small(const uint32_t* A, const uint32_t* B, float* C,
                        float* part, const float2* tab16, int M, int N,
                        int K, int ks, int S, euler::Posit pc,
                        euler::Planes pl, int sub_rem, cudaStream_t st) {
  auto kern = logmac_small_kernel<MR, VEC, FMT>;
  const int bytes = SM_FLOATS * (int)sizeof(float) +
                    (FMT == FMT_TABLE16 ? TABLE16 * (int)sizeof(float2) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + SM_BN - 1) / SM_BN, S);
  kern<<<grid, SM_THREADS, bytes, st>>>(A, B, C, part, tab16, M, N, K, ks,
                                        pc, pl, sub_rem);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const long long mn = (long long)M * N;
  logmac_splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      part, C, mn, S, sub_rem);
  return (int)cudaGetLastError();
}

template <int MR, bool VEC>
static int launch_small_fmt(int fmt, const uint32_t* A, const uint32_t* B,
                            float* C, float* part, const float2* tab16, int M,
                            int N, int K, int ks, int S, euler::Posit pc,
                            euler::Planes pl, int sub_rem, cudaStream_t st) {
  switch (fmt) {
    case FMT_TABLE8:
      return launch_small<MR, VEC, FMT_TABLE8>(A, B, C, part, tab16, M, N, K,
                                               ks, S, pc, pl, sub_rem, st);
    case FMT_TABLE16:
      return launch_small<MR, VEC, FMT_TABLE16>(A, B, C, part, tab16, M, N,
                                                K, ks, S, pc, pl, sub_rem, st);
    case FMT_P32:
      return launch_small<MR, VEC, FMT_P32>(A, B, C, part, tab16, M, N, K,
                                            ks, S, pc, pl, sub_rem, st);
    default:
      return launch_small<MR, VEC, FMT_ANY>(A, B, C, part, tab16, M, N, K,
                                            ks, S, pc, pl, sub_rem, st);
  }
}

template <int MR>
static int launch_small_mr(bool vec, int fmt, const uint32_t* A,
                           const uint32_t* B, float* C, float* part,
                           const float2* tab16, int M, int N, int K, int ks,
                           int S, euler::Posit pc, euler::Planes pl,
                           int sub_rem, cudaStream_t st) {
  if (vec)
    return launch_small_fmt<MR, true>(fmt, A, B, C, part, tab16, M, N, K, ks,
                                      S, pc, pl, sub_rem, st);
  return launch_small_fmt<MR, false>(fmt, A, B, C, part, tab16, M, N, K, ks,
                                       S, pc, pl, sub_rem, st);
}

// ---- the tensor-core kernel (M > 32, planes exact in fp16) ---------------

constexpr int MMA_BPS = 2;         // blocks per SM (launch bounds; 105 KB
                                   // of shared memory each at 128 rows)

template <int TM>
struct MmaShape {
  static constexpr int MI = TM / 32;   // m16 tiles per warp (warp: TM/2 rows)
  static constexpr int NI = 4;         // n8 tiles per warp (warp: 32 cols)
  static constexpr int RAW_A = TM * MMA_BK;            // words per stage
  static constexpr int RAW_B = MMA_BK * MMA_BN;
  static constexpr int PL_A = 2 * TM * MMA_LDA;        // halves: val, rem
  static constexpr int PL_B = 2 * MMA_BK * MMA_LDB;
  // dynamic shared memory: the raw ring, two decoded buffers, the table
  static constexpr int BYTES = MMA_STAGES * (RAW_A + RAW_B) * 4 +
                               2 * (PL_A + PL_B) * 2 + TABLE16 * 4;
};

// d += a (16x16, row) * b (16x8, col): fp16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A word's planes as one half2 word (val low, rem high) from the fp16
// table: FMT_TABLE8 indexes the 256 patterns; FMT_TABLE16 the top 12 body
// bits, the sign flipping both halves (as decode_word does in f32)
template <int FMT>
__device__ __forceinline__ uint32_t half_planes(uint32_t w,
                                                const uint32_t* tab) {
  if constexpr (FMT == FMT_TABLE8) {
    return tab[w & 0xFFu];
  } else {
    const uint32_t p = w & 0xFFFFu, sign = p >> 15;
    const uint32_t body = (sign ? 0u - p : p) & 0x7FFFu;
    const uint32_t t = tab[body >> 3] ^ (sign ? 0x80008000u : 0u);
    return body ? t : 0u;
  }
}

// Decode one stage into fp16 planes, two words a thread at a time: A as
// [val | rem] rows [m][k], B as [val ; -rem] rows [k][n], so one f32
// accumulator takes sum va*vb + sum ra*(-rb)
template <int TM, int FMT>
__device__ __forceinline__ void decode_stage(
    const uint32_t* __restrict__ ra, const uint32_t* __restrict__ rb,
    __half* __restrict__ pa, __half* __restrict__ pb,
    const uint32_t* __restrict__ tab, int tid) {
#pragma unroll
  for (int p = tid; p < TM * MMA_BK / 2; p += MMA_THREADS) {
    const int m = p / (MMA_BK / 2), k = (p % (MMA_BK / 2)) * 2;
    const uint2 w = *reinterpret_cast<const uint2*>(ra + m * MMA_BK + k);
    const uint32_t t0 = half_planes<FMT>(w.x, tab);
    const uint32_t t1 = half_planes<FMT>(w.y, tab);
    *reinterpret_cast<uint32_t*>(pa + m * MMA_LDA + k) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(pa + TM * MMA_LDA + m * MMA_LDA + k) =
        __byte_perm(t0, t1, 0x7632);
  }
#pragma unroll
  for (int p = tid; p < MMA_BK * MMA_BN / 2; p += MMA_THREADS) {
    const int k = p / (MMA_BN / 2), n = (p % (MMA_BN / 2)) * 2;
    const uint2 w = *reinterpret_cast<const uint2*>(rb + k * MMA_BN + n);
    const uint32_t t0 = half_planes<FMT>(w.x, tab);
    const uint32_t t1 = half_planes<FMT>(w.y, tab);
    *reinterpret_cast<uint32_t*>(pb + k * MMA_LDB + n) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(pb + MMA_BK * MMA_LDB + k * MMA_LDB + n) =
        __byte_perm(t0, t1, 0x7632) ^ 0x80008000u;
  }
}

// The products of one decoded stage into the warp's accumulators: per k16
// step, the val planes' MMAs and then (sub_rem) the rem planes' into the
// same accumulators
template <int TM>
__device__ __forceinline__ void mma_stage(
    const __half* __restrict__ pa, const __half* __restrict__ pb,
    float (&acc)[MmaShape<TM>::MI][MmaShape<TM>::NI][4], int wm, int wn,
    int lane, int sub_rem) {
  using S = MmaShape<TM>;
  const int planes = sub_rem ? 2 : 1;
#pragma unroll
  for (int kk = 0; kk < MMA_BK; kk += 16) {
    for (int pl = 0; pl < planes; ++pl) {
      const __half* a = pa + pl * TM * MMA_LDA;
      const __half* b = pb + pl * MMA_BK * MMA_LDB;
      uint32_t af[S::MI][4], bf[S::NI / 2][4];
#pragma unroll
      for (int i = 0; i < S::MI; ++i)
        ldmatrix_x4(af[i], a + (wm * (TM / 2) + i * 16 + (lane & 15)) *
                                   MMA_LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < S::NI / 2; ++j)
        ldmatrix_x4_trans(bf[j], b + (kk + (lane & 15)) * MMA_LDB +
                                     wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < S::MI; ++i)
#pragma unroll
        for (int j = 0; j < S::NI; ++j)
          mma16816(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                   bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
}

// C (or split z's [M, N] partial) = sum over K rows [z*ks, min(K, z*ks+ks))
// of va*vb - ra*rb.  Per stage: the copy of stage s+2 is issued, stage s+1
// is decoded while stage s is multiplied (two decoded buffers), one
// barrier per stage.
template <int TM, int FMT, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, MMA_BPS)
logmac_mma_kernel(const uint32_t* __restrict__ A,
                  const uint32_t* __restrict__ B, float* __restrict__ C,
                  float* __restrict__ part, const float2* __restrict__ tab16,
                  int M, int N, int K, int ks, euler::Posit pc,
                  euler::Planes pl, int sub_rem) {
  using S = MmaShape<TM>;
  extern __shared__ float4 smem4[];
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem4);
  __half* planes =
      reinterpret_cast<__half*>(raw + MMA_STAGES * (S::RAW_A + S::RAW_B));
  uint32_t* tab = reinterpret_cast<uint32_t*>(planes + 2 * (S::PL_A + S::PL_B));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * MMA_BN, m0 = blockIdx.y * TM;
  const int kbeg = blockIdx.z * ks, kend = min(K, kbeg + ks);
  const int nk = (kend - kbeg + MMA_BK - 1) / MMA_BK;

  auto raw_a = [&](int s) { return raw + (s % MMA_STAGES) * (S::RAW_A + S::RAW_B); };
  auto raw_b = [&](int s) { return raw_a(s) + S::RAW_A; };
  auto pl_a = [&](int s) { return planes + (s & 1) * (S::PL_A + S::PL_B); };
  auto pl_b = [&](int s) { return pl_a(s) + S::PL_A; };

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk)
      load_stage<TM, VEC>(raw_a(s), raw_b(s), A, B, M, N, K, m0, n0,
                          kbeg + s * MMA_BK, kend, tid);
    cp_async_commit();
  }
  if constexpr (FMT == FMT_TABLE8) {
    float v, r;
    euler::decode_planes((uint32_t)tid, pc, pl, &v, &r);
    __half2 h = __floats2half2_rn(v, r);
    tab[tid] = *reinterpret_cast<uint32_t*>(&h);
  } else {
    for (int i = tid; i < TABLE16; i += MMA_THREADS) {
      __half2 h = __float22half2_rn(tab16[i]);
      tab[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
  float acc[S::MI][S::NI][4];
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  cp_async_wait<MMA_STAGES - 2>();
  __syncthreads();  // stage 0 and the table are in shared memory
  if (nk > 0) decode_stage<TM, FMT>(raw_a(0), raw_b(0), pl_a(0), pl_b(0), tab, tid);
  for (int s = 0; s < nk; ++s) {
    const int nxt = s + MMA_STAGES - 1;
    if (nxt < nk)
      load_stage<TM, VEC>(raw_a(nxt), raw_b(nxt), A, B, M, N, K, m0, n0,
                          kbeg + nxt * MMA_BK, kend, tid);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 2>();
    // stage s+1's words are in; every warp is past stage s-1's products
    // and stage s's decode
    __syncthreads();
    if (s + 1 < nk)
      decode_stage<TM, FMT>(raw_a(s + 1), raw_b(s + 1), pl_a(s + 1),
                            pl_b(s + 1), tab, tid);
    mma_stage<TM>(pl_a(s), pl_b(s), acc, wm, wn, lane, sub_rem);
  }

  float* out = gridDim.z == 1 ? C : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = m0 + wm * (TM / 2) + i * 16 + (lane >> 2) + (c >> 1) * 8;
        const int gn = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (c & 1);
        if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[i][j][c];
      }
}

template <int TM, int FMT, bool VEC>
static int launch_mma(const uint32_t* A, const uint32_t* B, float* C,
                      float* part, const float2* tab16, int M, int N, int K,
                      int ks, int S, euler::Posit pc, euler::Planes pl,
                      int sub_rem, cudaStream_t st) {
  auto kern = logmac_mma_kernel<TM, FMT, VEC>;
  const int bytes = MmaShape<TM>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + TM - 1) / TM, S);
  kern<<<grid, MMA_THREADS, bytes, st>>>(A, B, C, part, tab16, M, N, K, ks,
                                         pc, pl, sub_rem);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return mma_reduce_launch(part, C, M, N, S, st);
}

template <int TM, int FMT>
static int launch_mma_vec(bool vec, const uint32_t* A, const uint32_t* B,
                          float* C, float* part, const float2* tab16, int M,
                          int N, int K, int ks, int S, euler::Posit pc,
                          euler::Planes pl, int sub_rem, cudaStream_t st) {
  if (vec)
    return launch_mma<TM, FMT, true>(A, B, C, part, tab16, M, N, K, ks, S,
                                     pc, pl, sub_rem, st);
  return launch_mma<TM, FMT, false>(A, B, C, part, tab16, M, N, K, ks, S, pc,
                                    pl, sub_rem, st);
}

extern "C" int logmac_launch(const uint32_t* A, const uint32_t* B, float* C,
                             int M, int N, int K, int pn, int pes, int pR,
                             int stages, int m_eff, int sub_rem,
                             void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  euler::Posit pc{pn, pes, pR};
  euler::Planes pl{stages, m_eff};
  logmac_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(A, B, C, M, N, K, pc,
                                                        pl, sub_rem);
  return (int)cudaGetLastError();
}

// The decode table of a 16-bit format (logmac_decode.cuh: FMT_TABLE16):
// TABLE16 (val, rem) pairs.
extern "C" int logmac_table16(float2* t, int pn, int pes, int pR, int stages,
                              int m_eff, void* stream) {
  if (pn != 16) return (int)cudaErrorInvalidValue;
  logmac_table16_kernel<<<TABLE16 / 256, 256, 0, (cudaStream_t)stream>>>(
      t, euler::Posit{pn, pes, pR}, euler::Planes{stages, m_eff});
  return (int)cudaGetLastError();
}

// mr: rows the kernel is built for (4, 8, 16 or 32, >= M); ks: K rows per
// split; S: splits (part holds 2*S*M*N floats when S > 1); vec: B's base
// and row stride allow the CPT-word vector loads; tab16: the format's
// logmac_table16 table, or null to decode without it
extern "C" int logmac_small_launch(const uint32_t* A, const uint32_t* B,
                                   float* C, float* part, const float2* tab16,
                                   int M, int N, int K, int ks, int S, int mr,
                                   int vec, int pn, int pes, int pR,
                                   int stages, int m_eff, int sub_rem,
                                   void* stream) {
  if (M <= 0 || N <= 0) return 0;
  euler::Posit pc{pn, pes, pR};
  euler::Planes pl{stages, m_eff};
  const int fmt = pick_format(pc, pl, tab16 != nullptr);
  if (M > mr || S < 1 || (S > 1 && part == nullptr) ||
      (tab16 != nullptr && pn != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mr) {
    case 4:
      return launch_small_mr<4>(vec, fmt, A, B, C, part, tab16, M, N, K, ks,
                                S, pc, pl, sub_rem, st);
    case 8:
      return launch_small_mr<8>(vec, fmt, A, B, C, part, tab16, M, N, K, ks,
                                S, pc, pl, sub_rem, st);
    case 16:
      return launch_small_mr<16>(vec, fmt, A, B, C, part, tab16, M, N, K, ks,
                                 S, pc, pl, sub_rem, st);
    case 32:
      return launch_small_mr<32>(vec, fmt, A, B, C, part, tab16, M, N, K, ks,
                                 S, pc, pl, sub_rem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core kernel (kernels/logmac.py: mma_key admits the format):
// bm = 64 or 128 rows per block; ks, S as logmac_small_launch (part holds
// S*M*N floats when S > 1); vec: A's and B's bases 16-byte aligned and K,
// N multiples of 4; tab16: the format's logmac_table16 table for a 16-bit
// format, null for an 8-bit one (its table is built per block)
extern "C" int logmac_mma_launch(const uint32_t* A, const uint32_t* B,
                                 float* C, float* part, const float2* tab16,
                                 int M, int N, int K, int ks, int S, int bm,
                                 int vec, int pn, int pes, int pR,
                                 int stages, int m_eff, int sub_rem,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  euler::Posit pc{pn, pes, pR};
  euler::Planes pl{stages, m_eff};
  if ((pn == 16) != (tab16 != nullptr) || (pn != 8 && pn != 16) || S < 1 ||
      (S > 1 && (part == nullptr || ks % MMA_BK != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v = vec != 0;
  if (bm == 64) {
    if (pn == 8)
      return launch_mma_vec<64, FMT_TABLE8>(v, A, B, C, part, tab16, M, N, K,
                                            ks, S, pc, pl, sub_rem, st);
    return launch_mma_vec<64, FMT_TABLE16>(v, A, B, C, part, tab16, M, N, K,
                                           ks, S, pc, pl, sub_rem, st);
  }
  if (bm == 128) {
    if (pn == 8)
      return launch_mma_vec<128, FMT_TABLE8>(v, A, B, C, part, tab16, M, N,
                                             K, ks, S, pc, pl, sub_rem, st);
    return launch_mma_vec<128, FMT_TABLE16>(v, A, B, C, part, tab16, M, N, K,
                                            ks, S, pc, pl, sub_rem, st);
  }
  return (int)cudaErrorInvalidValue;
}
