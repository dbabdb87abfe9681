// Paged flash-decode over posit-word KV pages.
//
// Replaces the TPU kernel repro/kernels/paged_decode.py:127
// _paged_decode_kernel (pl.pallas_call at :232, entry paged_flash_decode
// :196).  One block per (batch row b, KV head kv).  The block reads the
// slot's page ids from the page table itself and walks its pages with the
// online softmax held in shared memory.  Per page it:
//   1. decodes the K words to ILM planes (cache format, qk knobs);
//   2. computes the two-plane QK against the pre-encoded q planes, one warp
//      per (group row, slot position) pair;
//   3. scales, soft-caps, applies the causal + window mask;
//   4. updates the running max / sum, re-encodes exp(s - m) in the pv
//      format (no pre-scale) and decodes it to pv planes;
//   5. decodes the V words (cache format, pv knobs) and accumulates the
//      two-plane PV into acc.
// Pages that lie wholly outside [pos - window + 1, pos] are skipped: past
// pos they contribute pexp = 0 with alpha = 1, and leading window-masked
// pages are multiplied away by alpha = exp(-1e30 - m) = 0 at the first
// valid page, so the result is the same as visiting them.  If no page has
// a valid position, every page is visited, as the TPU grid does.
//
// Bound on the H100: bytes.  Each (b, kv) reads its pages' K and V words
// once (2 bytes per word for a uint16 cache) and does ~8 flops per word
// per group row; at batch 4 the grid has only B*KV = 16 blocks, so this
// simple kernel is latency-bound far above that floor.  See PERF.md.
#include <cuda_runtime.h>
#include "posit_common.cuh"

__device__ __forceinline__ uint32_t load_word(const void* base, size_t idx,
                                              int word_bytes) {
  if (word_bytes == 1) return ((const uint8_t*)base)[idx];
  if (word_bytes == 2) return ((const uint16_t*)base)[idx];
  return ((const uint32_t*)base)[idx];
}

struct DecodeArgs {
  int B, KV, G, hd, ps, nlp, window, word_bytes;
  float softcap;
  euler::Posit cache, qk_pc, pv_pc;
  euler::Planes qk, pv;
  int qk_sub, pv_sub;
};

__global__ void paged_decode_kernel(const uint32_t* __restrict__ qpat,
                                    const void* __restrict__ k_pages,
                                    const void* __restrict__ v_pages,
                                    const int* __restrict__ table,
                                    const int* __restrict__ pos_,
                                    const float* __restrict__ scl_,
                                    float* __restrict__ out, DecodeArgs a) {
  extern __shared__ float smem[];
  const int G = a.G, hd = a.hd, ps = a.ps, KV = a.KV;
  float* qv = smem;                 // [G*hd]
  float* qr = qv + G * hd;          // [G*hd]
  float* pv_ = qr + G * hd;         // [ps*hd] page planes (K, then V)
  float* pr_ = pv_ + ps * hd;       // [ps*hd]
  float* sb = pr_ + ps * hd;        // [G*ps] scores
  float* pbv = sb + G * ps;         // [G*ps] probability val plane
  float* pbr = pbv + G * ps;        // [G*ps] probability rem plane
  float* acc = pbr + G * ps;        // [G*hd]
  float* mrun = acc + G * hd;       // [G]
  float* lrun = mrun + G;           // [G]
  float* alpha = lrun + G;          // [G]

  const int b = blockIdx.x / KV, kv = blockIdx.x % KV;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int p = pos_[b];
  const int w = a.window;
  const float scl = scl_[0];

  const uint32_t* qb = qpat + (size_t)(b * KV + kv) * G * hd;
  for (int i = tid; i < G * hd; i += nthr) {
    euler::decode_planes(qb[i], a.qk_pc, a.qk, &qv[i], &qr[i]);
    acc[i] = 0.0f;
  }
  if (tid < G) {
    mrun[tid] = -1e30f;
    lrun[tid] = 0.0f;
  }

  int lo = 0, hi = a.nlp - 1;
  {
    int first = (w >= 0) ? p - w + 1 : 0;
    int plo = first > 0 ? first / ps : 0;
    int phi = p / ps;
    if (phi > a.nlp - 1) phi = a.nlp - 1;
    if (p >= 0 && plo <= phi) {
      lo = plo;
      hi = phi;
    }
  }
  __syncthreads();

  for (int j = lo; j <= hi; ++j) {
    const size_t page = (size_t)table[b * a.nlp + j];
    // 1. K words -> planes
    for (int i = tid; i < ps * hd; i += nthr) {
      int s = i / hd, d = i % hd;
      uint32_t wd = load_word(k_pages, ((page * ps + s) * KV + kv) * hd + d,
                              a.word_bytes);
      euler::decode_planes(wd, a.cache, a.qk, &pv_[i], &pr_[i]);
    }
    __syncthreads();
    // 2-3. scores
    for (int pair = warp; pair < G * ps; pair += nwarps) {
      int g = pair / ps, s = pair % ps;
      float sv = 0.0f, sr = 0.0f;
      for (int d = lane; d < hd; d += 32) {
        sv = fmaf(qv[g * hd + d], pv_[s * hd + d], sv);
        sr = fmaf(qr[g * hd + d], pr_[s * hd + d], sr);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_xor_sync(0xFFFFFFFFu, sv, o);
        sr += __shfl_xor_sync(0xFFFFFFFFu, sr, o);
      }
      if (lane == 0) {
        float sc = a.qk_sub ? sv - sr : sv;
        sc = sc * scl;
        if (a.softcap != 0.0f) sc = a.softcap * tanhf(sc / a.softcap);
        int spos = j * ps + s;
        bool ok = spos <= p && (w < 0 || spos > p - w);
        sb[pair] = ok ? sc : -1e30f;
      }
    }
    __syncthreads();
    // 4. online softmax + probability re-encode in the pv format
    if (tid < G) {
      const int g = tid;
      float mp = mrun[g];
      float mx = -INFINITY;
      for (int s = 0; s < ps; ++s) mx = fmaxf(mx, sb[g * ps + s]);
      float mn = fmaxf(mp, mx);
      float al = expf(mp - mn);
      float sum = 0.0f;
      for (int s = 0; s < ps; ++s) {
        float pe = expf(sb[g * ps + s] - mn);
        sum += pe;
        uint32_t pat = euler::encode_f32(pe, a.pv_pc);
        euler::decode_planes(pat, a.pv_pc, a.pv, &pbv[g * ps + s],
                             &pbr[g * ps + s]);
      }
      mrun[g] = mn;
      lrun[g] = lrun[g] * al + sum;
      alpha[g] = al;
    }
    // 5. V words -> planes (the K planes are no longer read)
    for (int i = tid; i < ps * hd; i += nthr) {
      int s = i / hd, d = i % hd;
      uint32_t wd = load_word(v_pages, ((page * ps + s) * KV + kv) * hd + d,
                              a.word_bytes);
      euler::decode_planes(wd, a.cache, a.pv, &pv_[i], &pr_[i]);
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += nthr) {
      int g = i / hd, d = i % hd;
      float ov = 0.0f, orr = 0.0f;
      for (int s = 0; s < ps; ++s) {
        ov = fmaf(pbv[g * ps + s], pv_[s * hd + d], ov);
        orr = fmaf(pbr[g * ps + s], pr_[s * hd + d], orr);
      }
      float o = a.pv_sub ? ov - orr : ov;
      acc[i] = acc[i] * alpha[g] + o;
    }
    __syncthreads();
  }
  float* ob = out + (size_t)(b * KV + kv) * G * hd;
  for (int i = tid; i < G * hd; i += nthr) {
    ob[i] = acc[i] / fmaxf(lrun[i / hd], 1e-30f);
  }
}

extern "C" int paged_decode_launch(
    const uint32_t* qpat, const void* k_pages, const void* v_pages,
    const int* table, const int* pos, const float* scl, float* out, int B,
    int KV, int G, int hd, int ps, int nlp, int window, int word_bytes,
    float softcap, int cN, int ces, int cR, int qN, int qes, int qR,
    int q_stages, int q_m, int vN, int ves, int vR, int v_stages, int v_m,
    void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  DecodeArgs a;
  a.B = B; a.KV = KV; a.G = G; a.hd = hd; a.ps = ps; a.nlp = nlp;
  a.window = window; a.word_bytes = word_bytes; a.softcap = softcap;
  a.cache = euler::Posit{cN, ces, cR};
  a.qk_pc = euler::Posit{qN, qes, qR};
  a.pv_pc = euler::Posit{vN, ves, vR};
  a.qk = euler::Planes{q_stages, q_m};
  a.pv = euler::Planes{v_stages, v_m};
  a.qk_sub = q_stages > 0;
  a.pv_sub = v_stages > 0;
  size_t floats = 3 * (size_t)G * hd + 2 * (size_t)ps * hd +
                  3 * (size_t)G * ps + 3 * (size_t)G;
  size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<<<B * KV, 256, bytes, (cudaStream_t)stream>>>(
      qpat, k_pages, v_pages, table, pos, scl, out, a);
  return (int)cudaGetLastError();
}
