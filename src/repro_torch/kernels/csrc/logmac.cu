// Fused logarithmic-posit MAC matmul: C[M,N] = sum_k va*vb - sum_k ra*rb.
//
// Replaces the TPU kernel repro/kernels/logmac.py:136 _logmac_kernel
// (pl.pallas_call at :168, entry logmac :150).  Inputs are posit patterns
// (uint32 words, low N bits valid), the output is the f32 "quire" value.
//
// Design: a shared-memory tile kernel.  A block owns a 64x64 output tile;
// for each K step of 16 it loads the A (64x16) and B (16x64) pattern tiles,
// decodes every element ONCE into its (val, rem) ILM planes in shared
// memory (euler::decode_planes, the counterpart of decode_planes_raw), and
// each of its 256 threads accumulates a 4x4 patch of two fp32 FMA sums,
// sum(va*vb) and sum(ra*rb), subtracted at the end as the reference does.
// Out-of-range rows/columns/K load the zero pattern, which decodes to zero
// planes (the reference pads with the zero pattern too).  fp32 CUDA cores
// are used rather than TF32/bf16 MMA: P16 L-21b planes carry 9
// significant bits, which bf16 does not hold exactly.
//
// Bound on the H100: at decode (M = batch = 4) the B patterns dominate and
// the kernel is bounded by bytes (4 bytes per weight word); at prefill
// (M >= 128) by the fp32 FMA rate (67 TFLOP/s, 4*M*N*K operations for the
// two planes).  This simple kernel reaches neither; see PERF.md.
#include <cuda_runtime.h>
#include "posit_common.cuh"

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
