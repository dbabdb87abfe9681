// logmac above 32 rows on bf16 tensor cores, for the formats whose planes
// fp16 cannot hold: C[M,N] = sum_k va*vb - sum_k ra*rb, as logmac.cu.
//
// Replaces the TPU kernel repro/kernels/logmac.py:136 _logmac_kernel
// (pl.pallas_call at :168) for M > 32 where kernels/logmac.py: mma_key
// refuses the format and pieces_key admits it: P32 L-21b and L-22b (the
// Posit-32 lane's truncated variants; L-21b is the guard's escalation
// format) and the P16 variants other than L-21b.  Those used to run
// logmac.cu's f32 tile kernel, on CUDA cores at 15 % of its f32 bound.
//
// The arithmetic.  Every f32 plane value that euler::decode_planes gives
// is an exact sum of a few bf16 pieces, each the round-to-nearest bf16 of
// what the earlier ones leave: the remainder of a rounding to 8
// significant bits is at most half its last place, so a value of b
// significant bits takes 1 piece for b <= 8 and one more for each further
// 9 bits.  A val plane has min(m + 1, 24) significant bits (m kept
// fraction bits; above 24 the plane is an f32 rounding), a rem plane at
// most m + 1 - stages: P32 L-21b (m 16, 12 stages) has 2 val pieces and 1
// rem piece, so 2 x 2 + 1 = 5 piece products per pair of words.  bf16 has
// f32's exponent range; pieces_key admits a format only where every piece
// is zero or a normal bf16 and every product of two pieces is at least
// 2^-126, so each product (at most 16 significant bits) is exact in the
// f32 accumulator and mma.sync m16n8k16 (bf16 in, f32 accumulate) computes
// the products of the f32 kernels exactly; only the order of the f32 sums
// differs, within chip_smoke's per-element bound.  Per k16 step the
// products go, in a fixed order and smallest first, into a step sum that
// is then added to the running sum (mma_pieces).
//
// The structure is logmac_mma_kernel's (logmac.cu): 64 rows x 128 columns
// a block (the running and the step sums take 64 registers a thread),
// two blocks an SM, 8 warps of 32 x 32, raw words through a ring of
// MMA_STAGES cp.async stages (mma_sync.cuh), each stage decoded once per
// block (P32
// L-21b with its knobs as constants, FMT_P32; any other format at run
// time) and split into piece planes in shared memory, A as [piece][m][k],
// B as [piece][k][n] read by ldmatrix .trans, two decoded buffers and one
// barrier per stage.  Six piece planes (P32 without truncation) do not
// fit two blocks an SM with two decoded buffers; pieces_key leaves those
// formats to the tile kernel.  Each row tile is split into S K ranges
// chosen from N, K and the format alone (kernels/logmac.py: _plan), and
// a tall call runs as several launches of whole row tiles, so a row's
// result is the same bits whatever rows share the call.  Partials go to
// an [S, rows, N] scratch that logmac_mma_reduce adds in split order.
//
// What bounds it, at M=128 [2304, 9216] P32 L-21b: the words' bytes
// 0.0271 ms at 3.35 TB/s; the 5 bf16 products 5 x 2MNK / 989 TFLOP/s =
// 0.0275 ms (mma.sync issues at a fraction of that rate); the arithmetic
// decode, on the integer pipes: each B word is decoded once per 64-row
// tile and each A word once per 128-column tile, 3 K*N decodes here
// against the 0.0406 ms floor of decoding B once.  The decode dominates;
// the design keeps it to one per word per block and overlaps it with the
// tensor cores through the two decoded buffers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "logmac_decode.cuh"
#include "mma_sync.cuh"

constexpr int PC_TM = 64;      // rows per block
constexpr int PC_BPS = 2;      // blocks per SM (launch bounds)
constexpr int PC_MAX_NP = 5;   // pieces a word at most (two blocks an SM)

template <int NP>
struct PiecesShape {
  static constexpr int MI = PC_TM / 32;    // m16 tiles per warp (32 rows)
  static constexpr int NI = 4;             // n8 tiles per warp (32 cols)
  static constexpr int RAW_A = PC_TM * MMA_BK;          // words per stage
  static constexpr int RAW_B = MMA_BK * MMA_BN;
  static constexpr int PL_A = NP * PC_TM * MMA_LDA;     // bf16 values
  static constexpr int PL_B = NP * MMA_BK * MMA_LDB;
  // dynamic shared memory: the raw ring and two decoded buffers
  static constexpr int BYTES = MMA_STAGES * (RAW_A + RAW_B) * 4 +
                               2 * (PL_A + PL_B) * 2;
  static_assert(NP <= PC_MAX_NP &&
                    PC_BPS * (BYTES + 1024) <= 228 * 1024,
                "PC_BPS blocks fit an SM");
};

// v as the sum of NPC bf16 values, each the round-to-nearest of what the
// earlier ones leave (exact where pieces_key admits the format)
template <int NPC>
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16* p) {
#pragma unroll
  for (int i = 0; i < NPC; ++i) {
    p[i] = __float2bfloat16_rn(v);
    v -= __bfloat162float(p[i]);
  }
}

// A word's PV val pieces, then its PR rem pieces (negated for B)
template <int PV, int PR, int FMT, bool NEG_REM>
__device__ __forceinline__ void word_pieces(uint32_t w,
                                            const euler::Posit& pc,
                                            const euler::Planes& pl,
                                            __nv_bfloat16 (&p)[PV + PR]) {
  float v, r;
  decode_word<FMT>(w, pc, pl, nullptr, v, r);
  split_bf16<PV>(v, p);
  if constexpr (PR > 0) split_bf16<PR>(NEG_REM ? -r : r, p + PV);
}

// Decode one stage into the piece planes, two words a thread at a time
template <int PV, int PR, int FMT>
__device__ __forceinline__ void decode_pieces(
    const uint32_t* __restrict__ ra, const uint32_t* __restrict__ rb,
    __nv_bfloat16* __restrict__ pa, __nv_bfloat16* __restrict__ pb,
    const euler::Posit& pc, const euler::Planes& pl, int tid) {
  constexpr int NP = PV + PR;
#pragma unroll
  for (int p = tid; p < PC_TM * MMA_BK / 2; p += MMA_THREADS) {
    const int m = p / (MMA_BK / 2), k = (p % (MMA_BK / 2)) * 2;
    const uint2 w = *reinterpret_cast<const uint2*>(ra + m * MMA_BK + k);
    __nv_bfloat16 x[NP], y[NP];
    word_pieces<PV, PR, FMT, false>(w.x, pc, pl, x);
    word_pieces<PV, PR, FMT, false>(w.y, pc, pl, y);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      *reinterpret_cast<__nv_bfloat162*>(
          pa + (i * PC_TM + m) * MMA_LDA + k) = __halves2bfloat162(x[i], y[i]);
  }
#pragma unroll
  for (int p = tid; p < MMA_BK * MMA_BN / 2; p += MMA_THREADS) {
    const int k = p / (MMA_BN / 2), n = (p % (MMA_BN / 2)) * 2;
    const uint2 w = *reinterpret_cast<const uint2*>(rb + k * MMA_BN + n);
    __nv_bfloat16 x[NP], y[NP];
    word_pieces<PV, PR, FMT, true>(w.x, pc, pl, x);
    word_pieces<PV, PR, FMT, true>(w.y, pc, pl, y);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      *reinterpret_cast<__nv_bfloat162*>(
          pb + (i * MMA_BK + k) * MMA_LDB + n) = __halves2bfloat162(x[i], y[i]);
  }
}

// d += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The piece products of one decoded stage (one k16 step) into the warp's
// accumulators.  They sum into a step accumulator from zero, smallest
// pieces first: the rem pairs, then the val pairs, A piece and B piece
// counting down, the two leading val pieces' product last; the step's sum
// is then added to the running one.  mma.sync's f32 accumulation is not
// round-to-nearest: with all five products of a step added to the
// running sum, the error grew with K past the tile kernel's; here the
// running sum takes one round-to-nearest add a step, and the small
// products never meet its magnitude.
template <int PV, int PR>
__device__ __forceinline__ void mma_pieces(
    const __nv_bfloat16* __restrict__ pa,
    const __nv_bfloat16* __restrict__ pb,
    float (&acc)[PiecesShape<PV + PR>::MI][PiecesShape<PV + PR>::NI][4],
    int wm, int wn, int lane) {
  using S = PiecesShape<PV + PR>;
  constexpr int NP = PV + PR;
  float step[S::MI][S::NI][4];
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) step[i][j][c] = 0.0f;
  uint32_t bf[NP][S::NI / 2][4];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < S::NI / 2; ++j)
      ldmatrix_x4_trans(bf[q][j], pb + (q * MMA_BK + (lane & 15)) * MMA_LDB +
                                      wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int p = NP - 1; p >= 0; --p) {
    uint32_t af[S::MI][4];
#pragma unroll
    for (int i = 0; i < S::MI; ++i)
      ldmatrix_x4(af[i], pa + (p * PC_TM + wm * (PC_TM / 2) + i * 16 +
                               (lane & 15)) * MMA_LDA + (lane >> 4) * 8);
#pragma unroll
    for (int q = NP - 1; q >= 0; --q) {
      if ((p < PV) != (q < PV)) continue;   // val with val, rem with rem
#pragma unroll
      for (int i = 0; i < S::MI; ++i)
#pragma unroll
        for (int j = 0; j < S::NI; ++j)
          mma_bf16(step[i][j], af[i], bf[q][j / 2][(j % 2) * 2],
                   bf[q][j / 2][(j % 2) * 2 + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += step[i][j][c];
}

// C (or split z's [M, N] partial) = sum over K rows [z*ks, min(K, z*ks+ks))
// of va*vb - ra*rb.  Per stage: the copy of stage s+2 is issued, stage s+1
// is decoded while stage s is multiplied (two decoded buffers), one
// barrier per stage.  vec: 16-byte copies (mma_sync.cuh: load_stage).
template <int PV, int PR, int FMT>
__global__ void __launch_bounds__(MMA_THREADS, PC_BPS)
logmac_pieces_kernel(const uint32_t* __restrict__ A,
                     const uint32_t* __restrict__ B, float* __restrict__ C,
                     float* __restrict__ part, int M, int N, int K, int ks,
                     int vec, euler::Posit pc, euler::Planes pl) {
  using S = PiecesShape<PV + PR>;
  extern __shared__ float4 smem4[];
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem4);
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(
      raw + MMA_STAGES * (S::RAW_A + S::RAW_B));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * MMA_BN, m0 = blockIdx.y * PC_TM;
  const int kbeg = blockIdx.z * ks, kend = min(K, kbeg + ks);
  const int nk = (kend - kbeg + MMA_BK - 1) / MMA_BK;

  auto raw_a = [&](int s) {
    return raw + (s % MMA_STAGES) * (S::RAW_A + S::RAW_B);
  };
  auto raw_b = [&](int s) { return raw_a(s) + S::RAW_A; };
  auto pl_a = [&](int s) { return planes + (s & 1) * (S::PL_A + S::PL_B); };
  auto pl_b = [&](int s) { return pl_a(s) + S::PL_A; };
  auto load = [&](int s) {
    const int k0 = kbeg + s * MMA_BK;
    if (vec)
      load_stage<PC_TM, true>(raw_a(s), raw_b(s), A, B, M, N, K, m0, n0, k0,
                              kend, tid);
    else
      load_stage<PC_TM, false>(raw_a(s), raw_b(s), A, B, M, N, K, m0, n0, k0,
                               kend, tid);
  };

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  float acc[S::MI][S::NI][4];
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  cp_async_wait<MMA_STAGES - 2>();
  __syncthreads();  // stage 0 is in shared memory
  if (nk > 0)
    decode_pieces<PV, PR, FMT>(raw_a(0), raw_b(0), pl_a(0), pl_b(0), pc, pl,
                               tid);
  for (int s = 0; s < nk; ++s) {
    const int nxt = s + MMA_STAGES - 1;
    if (nxt < nk) load(nxt);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 2>();
    // stage s+1's words are in; every warp is past stage s-1's products
    // and stage s's decode
    __syncthreads();
    if (s + 1 < nk)
      decode_pieces<PV, PR, FMT>(raw_a(s + 1), raw_b(s + 1), pl_a(s + 1),
                                 pl_b(s + 1), pc, pl, tid);
    mma_pieces<PV, PR>(pl_a(s), pl_b(s), acc, wm, wn, lane);
  }

  float* out = gridDim.z == 1 ? C : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm =
            m0 + wm * (PC_TM / 2) + i * 16 + (lane >> 2) + (c >> 1) * 8;
        const int gn = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (c & 1);
        if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[i][j][c];
      }
}

template <int PV, int PR, int FMT>
static int launch_pieces(const uint32_t* A, const uint32_t* B, float* C,
                         float* part, int M, int N, int K, int ks, int S,
                         int vec, euler::Posit pc, euler::Planes pl,
                         cudaStream_t st) {
  auto kern = logmac_pieces_kernel<PV, PR, FMT>;
  const int bytes = PiecesShape<PV + PR>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + MMA_BN - 1) / MMA_BN, (M + PC_TM - 1) / PC_TM, S);
  kern<<<grid, MMA_THREADS, bytes, st>>>(A, B, C, part, M, N, K, ks, vec, pc,
                                         pl);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return mma_reduce_launch(part, C, M, N, S, st);
}

// The bf16-piece kernel (kernels/logmac.py: pieces_key gives pv val and pr
// rem pieces a word); ks, S: K rows per split and splits (part holds
// S*M*N floats when S > 1); vec: A's and B's bases 16-byte aligned and K,
// N multiples of 4
extern "C" int logmac_pieces_launch(const uint32_t* A, const uint32_t* B,
                                    float* C, float* part, int M, int N,
                                    int K, int ks, int S, int pv, int pr,
                                    int vec, int pn, int pes, int pR,
                                    int stages, int m_eff, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (S < 1 || (S > 1 && (part == nullptr || ks % MMA_BK != 0)))
    return (int)cudaErrorInvalidValue;
  const euler::Posit pc{pn, pes, pR};
  const euler::Planes pl{stages, m_eff};
  cudaStream_t st = (cudaStream_t)stream;
  if (pick_format(pc, pl, false) == FMT_P32) {
    if (pv == 2 && pr == 1)
      return launch_pieces<2, 1, FMT_P32>(A, B, C, part, M, N, K, ks, S, vec,
                                          pc, pl, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (pv * 4 + pr) {
#define PIECES_CASE(V, R)                                                   \
  case V * 4 + R:                                                           \
    return launch_pieces<V, R, FMT_ANY>(A, B, C, part, M, N, K, ks, S, vec, \
                                        pc, pl, st);
    PIECES_CASE(1, 0)
    PIECES_CASE(1, 1)
    PIECES_CASE(2, 0)
    PIECES_CASE(2, 1)
    PIECES_CASE(2, 2)
    PIECES_CASE(3, 0)
    PIECES_CASE(3, 1)
    PIECES_CASE(3, 2)
#undef PIECES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
