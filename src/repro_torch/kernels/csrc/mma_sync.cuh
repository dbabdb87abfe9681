// What logmac's two tensor-core kernels share (logmac.cu:
// logmac_mma_kernel, logmac_pieces.cu: logmac_pieces_kernel): the block's
// geometry along N and K, the cp.async ring of raw words, ldmatrix, and
// the fixed-order reduce of split-K partials.
#pragma once
#include <stdint.h>
#include <cuda_runtime.h>

constexpr int MMA_THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int MMA_BN = 128;        // output columns per block
constexpr int MMA_BK = 16;         // K rows per pipeline stage
constexpr int MMA_STAGES = 3;      // raw-word stages in the ring (cp.async)
constexpr int MMA_LDA = MMA_BK + 8;   // halves per decoded A row (padding:
constexpr int MMA_LDB = MMA_BN + 8;   // ldmatrix rows hit distinct banks)

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One stage of raw words: A rows [m0, m0 + TM) x K rows [k0, k0 + BK), B K
// rows [k0, k0 + BK) x columns [n0, n0 + BN); words past M, N or kend are
// zero-filled (a zero word has zero planes).  VEC: 16-byte copies (bases
// 16-byte aligned, K and N multiples of 4), else 4-byte copies.
template <int TM, bool VEC>
__device__ __forceinline__ void load_stage(
    uint32_t* __restrict__ ra, uint32_t* __restrict__ rb,
    const uint32_t* __restrict__ A, const uint32_t* __restrict__ B, int M,
    int N, int K, int m0, int n0, int k0, int kend, int tid) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int ACH = TM * MMA_BK / W, BCH = MMA_BK * MMA_BN / W;
#pragma unroll
  for (int c = tid; c < ACH; c += MMA_THREADS) {
    const int m = c / (MMA_BK / W), k = (c % (MMA_BK / W)) * W;
    const bool in = m0 + m < M && k0 + k < kend;
    const uint32_t* src = in ? A + (size_t)(m0 + m) * K + k0 + k : A;
    if constexpr (VEC) cp_async16(ra + m * MMA_BK + k, src, in);
    else cp_async4(ra + m * MMA_BK + k, src, in);
  }
#pragma unroll
  for (int c = tid; c < BCH; c += MMA_THREADS) {
    const int k = c / (MMA_BN / W), n = (c % (MMA_BN / W)) * W;
    const bool in = k0 + k < kend && n0 + n < N;
    const uint32_t* src = in ? B + (size_t)(k0 + k) * N + n0 + n : B;
    if constexpr (VEC) cp_async16(rb + k * MMA_BN + n, src, in);
    else cp_async4(rb + k * MMA_BN + n, src, in);
  }
}

// C = sum_s part[s] over the [S, M, N] partials, in split order
__global__ void logmac_mma_reduce(const float* __restrict__ part,
                                  float* __restrict__ C, long long mn,
                                  int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += part[z * mn + i];
  C[i] = s;
}

// The reduce of S > 1 partials into C, after a split-K launch
static inline int mma_reduce_launch(const float* part, float* C, int M,
                                    int N, int S, cudaStream_t st) {
  const long long mn = (long long)M * N;
  logmac_mma_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, C,
                                                                   mn, S);
  return (int)cudaGetLastError();
}
