// Paged flash-decode over posit-word KV pages, page-parallel.
//
// Replaces the TPU kernel repro/kernels/paged_decode.py:127
// _paged_decode_kernel (pl.pallas_call at :232, entry paged_flash_decode
// :196), which walks a slot's pages in grid order with the online softmax
// carried in scratch.  Per page it decodes the K words to ILM planes,
// computes the two-plane QK, scales, soft-caps and masks (causal and
// window), encodes exp(s - m_j) in the pv format, where m_j is the running
// max after page j, and adds the two-plane PV into acc rescaled by
// alpha = exp(m_{j-1} - m_j).
//
// What bounds it on the H100.  Its bytes (a few hundred KB per call at the
// serving geometry) and operations are tiny; the serial walk of one block
// per (b, kv) is a chain of latencies, 16 blocks at batch 4 and as long as
// the context, and a call's time was mostly the host's issue of q's
// pre-scale (a dozen small torch ops) and encode.  So q's pre-scale and
// encode are one launch, and the work is spread over pages, a block taking
// a chunk of ppb consecutive pages (1 up to 64-page tables;
// kernels/paged_decode.py: pages_per_block):
//
//   q prep, one block: sq = 2^round(mean log2|q| over q's normal nonzero
//     elements: XLA's flush reads a subnormal as 0 in the reference's
//     _pow2_scale), at least 1e-30 (1 without pre-scale), as the plain
//     version's _q_setup; scl = sq / sqrt(hd); q / sq encoded in the qk
//     format (a fixed-order block sum);
//   pass 1, grid (chunk, b*kv): decode q's planes once, then per page the
//     K words, the G x ps scores (one warp per (g, s) pair) with scale,
//     softcap and mask, and the page's max per g;
//   pass 2, grid (chunk, b*kv): m_j = the prefix max of the page maxima up
//     to page j (the serial kernel's running max), m_last = the max over
//     all visited pages; per page, pexp = exp(s - m_j), summed in f32
//     before it is encoded and decoded in the pv format (one thread per
//     (g, s) pair, while the other threads decode the V words), and the
//     two-plane PV; the chunk's acc and l add each page's PV and sum
//     weighted by exp(m_j - m_last), the telescoped product of the serial
//     kernel's alphas, in page order;
//   combine, grid (b*kv): out = sum_c acc_c / max(sum_c l_c, 1e-30) in
//     chunk order.
//
// Posit rounding is not scale-invariant, so each page's probabilities are
// encoded against the same m_j as in the serial walk: the same function up
// to f32 reassociation of the sums.  No float atomics: fixed orders only.
// The visited pages are the serial kernel's: those meeting
// [pos - window + 1, pos], or every page where no position is valid.  A
// leading masked page has m_j = -1e30 and so weight 0, as alpha makes it
// in the serial walk.  A block loads each page's words PAGE_BATCH at a time
// before decoding them, so a page costs a few load latencies.
#include <cuda_runtime.h>
#include "logmac_decode.cuh"

__device__ __forceinline__ uint32_t load_word(const void* base, size_t idx,
                                              int word_bytes) {
  if (word_bytes == 1) return ((const uint8_t*)base)[idx];
  if (word_bytes == 2) return ((const uint16_t*)base)[idx];
  return ((const uint32_t*)base)[idx];
}

struct DecodeArgs {
  int B, KV, G, hd, ps, nlp, ppb, nchunk, window, word_bytes;
  float softcap;
  euler::Posit cache, qk_pc, pv_pc;
  euler::Planes qk, pv;
  int qk_sub, pv_sub;
};

// The pages a slot visits: [lo, hi].
__device__ __forceinline__ void visit_range(int p, const DecodeArgs& a,
                                            int* lo, int* hi) {
  *lo = 0;
  *hi = a.nlp - 1;
  int first = (a.window >= 0) ? p - a.window + 1 : 0;
  int plo = first > 0 ? first / a.ps : 0;
  int phi = p / a.ps;
  if (phi > a.nlp - 1) phi = a.nlp - 1;
  if (p >= 0 && plo <= phi) {
    *lo = plo;
    *hi = phi;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

// Scratch layout (floats): per (b*kv) row and page j, and per chunk c of
// ppb pages, then q's words and scale:
//   scores [BKV][nlp][G][ps], pmax [BKV][nlp][G],
//   accs   [BKV][nchunk][G][hd], ls [BKV][nchunk][G],
//   qpat   [BKV][G][hd] (uint32 words), scl [1]
struct Scratch {
  float *scores, *pmax, *accs, *ls;
  uint32_t* qpat;
  float* scl;
};

// q's pre-scale and encode (see the header): n floats of q -> qk words.
constexpr int QP_THREADS = 1024;

__global__ void __launch_bounds__(QP_THREADS)
pd_q_prep_kernel(const float* __restrict__ q, int n, int pre_scale,
                 float inv_sqrt_hd, euler::Posit qk_pc, Scratch sc) {
  __shared__ float wsum[QP_THREADS / 32];
  __shared__ int wcnt[QP_THREADS / 32];
  __shared__ float sq_s;
  const int tid = threadIdx.x, lane = tid & 31;
  float s = 0.0f;
  int c = 0;
  if (pre_scale) {
    for (int i = tid; i < n; i += QP_THREADS) {
      const float ax = fabsf(q[i]);
      if (ax >= 0x1p-126f) {
        s += log2f(ax);
        ++c;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
    c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
  }
  if (lane == 0) {
    wsum[tid >> 5] = s;
    wcnt[tid >> 5] = c;
  }
  __syncthreads();
  if (tid == 0) {
    float ts = 0.0f;
    int tc = 0;
    for (int w = 0; w < QP_THREADS / 32; ++w) {
      ts += wsum[w];
      tc += wcnt[w];
    }
    const float sq =
        pre_scale ? fmaxf(exp2f(rintf(ts / (float)max(tc, 1))), 1e-30f) : 1.0f;
    sq_s = sq;
    sc.scl[0] = sq * inv_sqrt_hd;
  }
  __syncthreads();
  const float sq = sq_s;
  for (int i = tid; i < n; i += QP_THREADS)
    sc.qpat[i] =
        euler::encode_f32(euler::flush_subnormal(q[i]) / sq, qk_pc);
}

// FX: the wrapper passed one 16-bit decode table for every format here
// (the cache, q's and the probabilities' formats and both plane knobs are
// one format that takes a table, as the served P16 L-21b does;
// kernels/paged_decode.py).  Then every word -- q, the K and V pages, the
// encoded probabilities -- is decoded through that 4096-entry table
// (logmac_decode.cuh: FMT_TABLE16), copied into shared memory once per
// block; otherwise by euler::decode_planes with the knobs read at run
// time.  Both give the same planes.
template <bool FX>
struct Decoder {
  const float2* tab;
  __device__ __forceinline__ void operator()(uint32_t w, euler::Posit pc,
                                             euler::Planes pl, float* v,
                                             float* r) const {
    if constexpr (FX) {
      decode_word<FMT_TABLE16>(w, pc, pl, tab, *v, *r);
    } else {
      euler::decode_planes(w, pc, pl, v, r);
    }
  }
};

// A page's words of head kv -> planes [ps*hd], the block's threads taking
// PAGE_BATCH words each at a time: all their loads are issued before the
// first is decoded, so a page costs a few load latencies, not one a word.
constexpr int PAGE_BATCH = 8;

template <class Dec>
__device__ __forceinline__ void decode_page(const Dec& dec, const void* pages,
                                            size_t page, int kv,
                                            const DecodeArgs& a,
                                            euler::Planes pl, float* v,
                                            float* r) {
  const int n = a.ps * a.hd, nthr = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += nthr * PAGE_BATCH) {
    uint32_t wd[PAGE_BATCH];
#pragma unroll
    for (int u = 0; u < PAGE_BATCH; ++u) {
      const int i = i0 + u * nthr;
      const int s = i / a.hd, d = i % a.hd;
      wd[u] = i < n ? load_word(pages,
                                ((page * a.ps + s) * a.KV + kv) * a.hd + d,
                                a.word_bytes)
                    : 0u;
    }
#pragma unroll
    for (int u = 0; u < PAGE_BATCH; ++u) {
      const int i = i0 + u * nthr;
      if (i < n) dec(wd[u], a.cache, pl, &v[i], &r[i]);
    }
  }
}

// The pages of chunk c that its slot visits: [*j0, *j1] (empty if j0 > j1).
__device__ __forceinline__ void chunk_pages(int p, const DecodeArgs& a, int c,
                                            int* lo, int* hi, int* j0,
                                            int* j1) {
  visit_range(p, a, lo, hi);
  *j0 = max(*lo, c * a.ppb);
  *j1 = min(*hi, c * a.ppb + a.ppb - 1);
}

// Copies the decode table into shared memory (FX only).
template <bool FX>
__device__ __forceinline__ void load_table(const float2* __restrict__ tab16,
                                           float2* tab) {
  if constexpr (FX) {
    const float4* src = reinterpret_cast<const float4*>(tab16);
    float4* dst = reinterpret_cast<float4*>(tab);
    for (int i = threadIdx.x; i < TABLE16 / 2; i += blockDim.x)
      dst[i] = src[i];
  }
}

template <bool FX>
__global__ void pd_scores_kernel(const void* __restrict__ k_pages,
                                 const int* __restrict__ table,
                                 const int* __restrict__ pos_,
                                 const float2* __restrict__ tab16, Scratch sc,
                                 DecodeArgs a) {
  extern __shared__ float4 smem4[];
  const int G = a.G, hd = a.hd, ps = a.ps, KV = a.KV;
  float2* tab = reinterpret_cast<float2*>(smem4);   // [TABLE16] if FX
  float* qv = reinterpret_cast<float*>(tab + (FX ? TABLE16 : 0));
  float* qr = qv + G * hd;          // [G*hd]
  float* kv_ = qr + G * hd;         // [ps*hd]
  float* kr = kv_ + ps * hd;        // [ps*hd]
  float* sb = kr + ps * hd;         // [G*ps]

  const int bk = blockIdx.y, b = bk / KV, kv = bk % KV;
  const int p = pos_[b];
  int lo, hi, j0, j1;
  chunk_pages(p, a, blockIdx.x, &lo, &hi, &j0, &j1);
  if (j0 > j1) return;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int w = a.window;
  const float scl = sc.scl[0];
  const Decoder<FX> dec{tab};

  load_table<FX>(tab16, tab);
  __syncthreads();
  const uint32_t* qb = sc.qpat + (size_t)bk * G * hd;
  for (int i = tid; i < G * hd; i += nthr)
    dec(qb[i], a.qk_pc, a.qk, &qv[i], &qr[i]);
  for (int j = j0; j <= j1; ++j) {
    if (j > j0) __syncthreads();     // the last page's planes are read
    decode_page(dec, k_pages, (size_t)table[b * a.nlp + j], kv, a, a.qk,
                kv_, kr);
    __syncthreads();
    float* srow = sc.scores + ((size_t)bk * a.nlp + j) * G * ps;
    for (int pair = warp; pair < G * ps; pair += nwarps) {
      int g = pair / ps, s = pair % ps;
      float sv = 0.0f, sr = 0.0f;
      for (int d = lane; d < hd; d += 32) {
        sv = fmaf(qv[g * hd + d], kv_[s * hd + d], sv);
        sr = fmaf(qr[g * hd + d], kr[s * hd + d], sr);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_xor_sync(0xFFFFFFFFu, sv, o);
        sr += __shfl_xor_sync(0xFFFFFFFFu, sr, o);
      }
      if (lane == 0) {
        float x = a.qk_sub ? sv - sr : sv;
        x = x * scl;
        if (a.softcap != 0.0f) x = a.softcap * tanhf(x / a.softcap);
        int spos = j * ps + s;
        bool ok = spos <= p && (w < 0 || spos > p - w);
        x = ok ? x : -1e30f;
        sb[pair] = x;
        srow[pair] = x;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float mx = -INFINITY;
      for (int s = lane; s < ps; s += 32) mx = fmaxf(mx, sb[g * ps + s]);
      mx = warp_max(mx);
      if (lane == 0) sc.pmax[((size_t)bk * a.nlp + j) * G + g] = mx;
    }
  }
}

template <bool FX>
__global__ void pd_values_kernel(const void* __restrict__ v_pages,
                                 const int* __restrict__ table,
                                 const int* __restrict__ pos_,
                                 const float2* __restrict__ tab16, Scratch sc,
                                 DecodeArgs a) {
  extern __shared__ float4 smem4[];
  const int G = a.G, hd = a.hd, ps = a.ps, KV = a.KV;
  float2* tab = reinterpret_cast<float2*>(smem4);   // [TABLE16] if FX
  float* vv = reinterpret_cast<float*>(tab + (FX ? TABLE16 : 0));
  float* vr = vv + ps * hd;         // [ps*hd]
  float* acc = vr + ps * hd;        // [G*hd] weighted PV of the chunk
  float* pbv = acc + G * hd;        // [G*ps] probability val plane
  float* pbr = pbv + G * ps;        // [G*ps] probability rem plane
  float* pe_s = pbr + G * ps;       // [G*ps] exp(s - m_j) before encode
  float* mj = pe_s + G * ps;        // [ppb*G] m_j of the chunk's pages
  float* wgt = mj + a.ppb * G;      // [ppb*G] exp(m_j - m_last)
  float* lacc = wgt + a.ppb * G;    // [G] weighted sum of the chunk

  const int bk = blockIdx.y, b = bk / KV, kv = bk % KV;
  const int p = pos_[b];
  int lo, hi, j0, j1;
  chunk_pages(p, a, blockIdx.x, &lo, &hi, &j0, &j1);
  if (j0 > j1) return;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const Decoder<FX> dec{tab};

  load_table<FX>(tab16, tab);
  // m_j of each page of the chunk (the prefix max of the page maxima) and
  // its weight exp(m_j - m_last); max is exact in any order
  const float* pm = sc.pmax + (size_t)bk * a.nlp * G;
  for (int g = warp; g < G; g += nwarps) {
    float mp = -1e30f, ml = -1e30f;
    for (int i = lo + lane; i <= hi; i += 32) {
      float x = pm[i * G + g];
      ml = fmaxf(ml, x);
      if (i < j0) mp = fmaxf(mp, x);
    }
    mp = warp_max(mp);
    ml = warp_max(ml);
    if (lane == 0) {
      for (int j = j0; j <= j1; ++j) {
        mp = fmaxf(mp, pm[j * G + g]);
        mj[(j - j0) * G + g] = mp;
        wgt[(j - j0) * G + g] = expf(mp - ml);
      }
      lacc[g] = 0.0f;
    }
  }
  for (int i = tid; i < G * hd; i += nthr) acc[i] = 0.0f;
  __syncthreads();
  for (int j = j0; j <= j1; ++j) {
    if (j > j0) __syncthreads();     // the last page is added in
    const float* mjj = mj + (j - j0) * G;
    const float* wj = wgt + (j - j0) * G;
    // the probabilities (encoded against m_j) while the V words decode
    const float* srow = sc.scores + ((size_t)bk * a.nlp + j) * G * ps;
    for (int pair = tid; pair < G * ps; pair += nthr) {
      float pe = expf(srow[pair] - mjj[pair / ps]);
      pe_s[pair] = pe;
      uint32_t pat = euler::encode_f32(pe, a.pv_pc);
      dec(pat, a.pv_pc, a.pv, &pbv[pair], &pbr[pair]);
    }
    decode_page(dec, v_pages, (size_t)table[b * a.nlp + j], kv, a, a.pv,
                vv, vr);
    __syncthreads();
    if (tid < G) {
      float l = 0.0f;
      for (int s = 0; s < ps; ++s) l += pe_s[tid * ps + s];
      lacc[tid] += l * wj[tid];
    }
    for (int i = tid; i < G * hd; i += nthr) {
      int g = i / hd, d = i % hd;
      float ov = 0.0f, orr = 0.0f;
      for (int s = 0; s < ps; ++s) {
        ov = fmaf(pbv[g * ps + s], vv[s * hd + d], ov);
        orr = fmaf(pbr[g * ps + s], vr[s * hd + d], orr);
      }
      acc[i] += (a.pv_sub ? ov - orr : ov) * wj[g];
    }
  }
  __syncthreads();
  const size_t row = (size_t)bk * a.nchunk + blockIdx.x;
  for (int i = tid; i < G * hd; i += nthr) sc.accs[row * G * hd + i] = acc[i];
  if (tid < G) sc.ls[row * G + tid] = lacc[tid];
}

__global__ void pd_combine_kernel(const int* __restrict__ pos_, Scratch sc,
                                  float* __restrict__ out, DecodeArgs a) {
  const int G = a.G, hd = a.hd;
  const int bk = blockIdx.x, b = bk / a.KV;
  int lo, hi;
  visit_range(pos_[b], a, &lo, &hi);
  const int c0 = lo / a.ppb, c1 = hi / a.ppb;
  const float* ls = sc.ls + (size_t)bk * a.nchunk * G;
  const float* accs = sc.accs + (size_t)bk * a.nchunk * G * hd;
  float* ob = out + (size_t)bk * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd;
    float acc = 0.0f, l = 0.0f;
    for (int c = c0; c <= c1; ++c) {
      acc += accs[(size_t)c * G * hd + i];
      l += ls[c * G + g];
    }
    ob[i] = acc / fmaxf(l, 1e-30f);
  }
}

extern "C" int paged_decode_launch(
    const float* q, const void* k_pages, const void* v_pages,
    const int* table, const int* pos, const float2* tab16, float* out,
    float* scratch, int B, int KV, int G, int hd, int ps, int nlp, int ppb,
    int window, int word_bytes, int pre_scale, float softcap,
    float inv_sqrt_hd, int cN, int ces,
    int cR, int qN, int qes, int qR, int q_stages, int q_m, int vN, int ves,
    int vR, int v_stages, int v_m, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  if (nlp <= 0 || ppb <= 0) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.B = B; a.KV = KV; a.G = G; a.hd = hd; a.ps = ps; a.nlp = nlp;
  a.ppb = ppb; a.nchunk = (nlp + ppb - 1) / ppb;
  a.window = window; a.word_bytes = word_bytes; a.softcap = softcap;
  a.cache = euler::Posit{cN, ces, cR};
  a.qk_pc = euler::Posit{qN, qes, qR};
  a.pv_pc = euler::Posit{vN, ves, vR};
  a.qk = euler::Planes{q_stages, q_m};
  a.pv = euler::Planes{v_stages, v_m};
  a.qk_sub = q_stages > 0;
  a.pv_sub = v_stages > 0;
  const size_t pages = (size_t)B * KV * nlp, chunks = (size_t)B * KV * a.nchunk;
  Scratch sc;
  sc.scores = scratch;
  sc.pmax = sc.scores + pages * G * ps;
  sc.accs = sc.pmax + pages * G;
  sc.ls = sc.accs + chunks * G * hd;
  sc.qpat = reinterpret_cast<uint32_t*>(sc.ls + chunks * G);
  sc.scl = reinterpret_cast<float*>(sc.qpat + (size_t)B * KV * G * hd);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(a.nchunk, B * KV);

  const bool fx = tab16 != nullptr;
  if (fx && (cN != 16 || qN != 16 || vN != 16))
    return (int)cudaErrorInvalidValue;
  const size_t tbytes = fx ? TABLE16 * sizeof(float2) : 0;
  const size_t b1 = tbytes + (2 * (size_t)G * hd + 2 * (size_t)ps * hd +
                              (size_t)G * ps) * sizeof(float);
  const size_t b2 = tbytes + (2 * (size_t)ps * hd + (size_t)G * hd +
                              3 * (size_t)G * ps + (2 * (size_t)ppb + 1) * G) *
                                 sizeof(float);
  auto scores = fx ? pd_scores_kernel<true> : pd_scores_kernel<false>;
  auto values = fx ? pd_values_kernel<true> : pd_values_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      scores, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      values, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return (int)err;
  pd_q_prep_kernel<<<1, QP_THREADS, 0, st>>>(q, B * KV * G * hd, pre_scale,
                                             inv_sqrt_hd, a.qk_pc, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scores<<<grid, 256, b1, st>>>(k_pages, table, pos, tab16, sc, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  values<<<grid, 256, b2, st>>>(v_pages, table, pos, tab16, sc, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pd_combine_kernel<<<B * KV, 256, 0, st>>>(pos, sc, out, a);
  return (int)cudaGetLastError();
}
