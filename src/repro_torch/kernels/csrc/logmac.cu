// Fused logarithmic-posit MAC matmul: C[M,N] = sum_k va*vb - sum_k ra*rb.
//
// Replaces the TPU kernel repro/kernels/logmac.py:136 _logmac_kernel
// (pl.pallas_call at :168, entry logmac :150).  Inputs are posit patterns
// (uint32 words, low N bits valid), the output is the f32 "quire" value.
// Every word is decoded into the (val, rem) ILM planes euler::decode_planes
// gives, the counterpart of decode_planes_raw.  fp32 CUDA
// cores are used rather than TF32/bf16 MMA: P16 L-21b planes carry 9
// significant bits, which bf16 does not hold exactly.  No float atomics:
// two launches on the same input give the same bits.
//
// What bounds it on the H100.  Every main-path launch has M <= 32 (decode
// M = batch, prefill M = 16 or 32).  There the work is the K x N weight
// words: 4 bytes each (3.35 TB/s) against the decode of each word into two
// planes (euler::decode_planes: some 50 SASS instructions for P16) and
// only 4*M FMAs.  Decoded arithmetically, the words' integer work bounds
// the kernel, not their bytes.  So:
//
// * logmac_small_kernel (M <= 32) decodes each B word exactly once and
//   feeds it to all M rows.  A block owns SM_BN = 128 columns and one
//   K-split; its 8 warps are WN along N and WK along K.  A thread owns CPT
//   consecutive columns (4, 2 or 1 as M grows, so that its MR x CPT x 2
//   accumulators stay at <= 64 registers) and loads their words with one
//   16/8/4-byte load per K row, coalesced across the warp, U rows at a
//   time with the next U in flight.  A's rows of the K-slice are decoded
//   once per block into shared memory as two planes, [k][MR], read as
//   float4 broadcasts.  The served P16 words decode through a 4096-entry
//   table in shared memory and P8 through a 256-entry one (both built by
//   euler::decode_planes; logmac_decode.cuh), which leaves them bound by
//   their bytes; P32 L-21b decodes arithmetically with its knobs as
//   constants, any other format with its knobs read at run time.
//   The WK warp groups' partial sums are added in a fixed order through
//   shared memory; with S K-splits each block writes its v and r partials
//   to a [S, 2, M, N] scratch and logmac_splitk_reduce adds them in split
//   order and subtracts r from v, as the reference does; with S = 1 the
//   block writes C directly.  The plan (kernels/logmac.py: _plan) picks S
//   so that the grid is one wave of two blocks per SM.
// * logmac_kernel (M > 32): the 64x64 shared-memory tile kernel; each
//   element of an A or B tile is decoded once per tile.
#include <cuda_runtime.h>
#include "logmac_decode.cuh"

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
