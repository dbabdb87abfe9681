// The per-tensor pow2 pre-scale on the card, and the partition of a tensor
// that the kernels which read it share: posit_encode.cu (the fused
// pre-scale + encode of the cuda backend's operands) and
// posit_core_codec.cu (the guard's quantize check and sentinels).  All
// three compute s by the same reduce launch and the same fixed trees, so
// on the same tensor they give the same s, bit for bit.
//
// s = max(2^rint(sum lg / max(count, 1)), 1e-30) over lg = log2|x| of the
// values with |x| >= 2^-126, the steps of _pow2_scale: the reference
// counts |x| > 0 under XLA's flush, which reads a subnormal as 0 (NaN is
// not counted, Inf is):
//   reduce launch: a fixed grid; each thread sums its share in f64 with
//     an exact int64 count, each block adds its threads' sums by a fixed
//     tree into one partial of a [blocks] scratch;
//   consumer launch (a programmatic dependent launch): every block builds
//     its encode table, waits for the reduce grid and adds the partials
//     by the same fixed tree, so all blocks get the same s without a third
//     launch or a host sync.
// No float atomics: two launches on the same input give the same bits.
//
// The partition (kernels/posit_codec.py: _encode_plan mirrors it): the
// first `head` values, up to x's first 16-byte boundary, go one to a
// thread; then float4 vectors in a grid-stride loop, UNROLL loads a thread
// at a time; then the last (n - head) % 4 values, one to a thread.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#include "posit_common.cuh"

constexpr int ENC_THREADS = 256;
constexpr int RED_THREADS = 256;
constexpr int UNROLL = 4;
// blocks of the encode and reduce launches resident on an SM (at most 64
// registers a thread); the plan caps both grids at one such wave
constexpr int BLOCKS_PER_SM = 4;

namespace {

struct Partial {
  double sum;
  long long count;
};

// Values before x's first 16-byte boundary (x is 4-byte aligned).
__device__ __forceinline__ long long head_of(const float* x, long long n) {
  long long h = (long long)((16 - ((uintptr_t)x & 15)) & 15) >> 2;
  return h < n ? h : n;
}

// log2|v| where v is normal and nonzero (counted in c), else 0.
__device__ __forceinline__ float lg_of(float v, int& c) {
  const float a = fabsf(v);
  const bool nz = a >= 0x1p-126f;
  c += nz;
  return nz ? log2f(a) : 0.0f;
}

// Calls f(v, x4) for a thread's vectors v = gtid + j * G in ascending
// order, UNROLL at a time, the next UNROLL loads in flight while the
// current ones are worked.
template <class F>
__device__ __forceinline__ void each_vector(const float4* __restrict__ xv,
                                            long long nv, long long gtid,
                                            long long G, F&& f) {
  float4 cur[UNROLL] = {}, nxt[UNROLL] = {};
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (gtid + u * G < nv) cur[u] = xv[gtid + u * G];
  for (long long v = gtid; v < nv; v += UNROLL * G) {
    const long long vn = v + UNROLL * G;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (vn + u * G < nv) nxt[u] = xv[vn + u * G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * G < nv) f(v + u * G, cur[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
  }
}

// One thread's share of the partition in its fixed order: f1(i, x[i]) for
// its head value, f4(v, x4) for its vectors (v counted from the head's
// end), f1 for its tail value.
template <class F1, class F4>
__device__ __forceinline__ void each_share(const float* __restrict__ x,
                                           long long n, long long gtid,
                                           long long G, F1&& f1, F4&& f4) {
  const long long h = head_of(x, n);
  if (gtid < h) f1(gtid, x[gtid]);
  const long long nv = (n - h) >> 2;
  each_vector(reinterpret_cast<const float4*>(x + h), nv, gtid, G, f4);
  const long long t0 = h + 4 * nv;
  if (gtid < n - t0) f1(t0 + gtid, x[t0 + gtid]);
}

// out[i] = f(x[i]) (4-byte words) over one thread's share; a vector's four
// words go out as one 16-byte store where out lies 16-byte aligned at x's
// first boundary, else singly.
template <class F>
__device__ __forceinline__ void map_share(const float* __restrict__ x,
                                          uint32_t* __restrict__ out,
                                          long long n, long long gtid,
                                          long long G, F&& f) {
  uint32_t* ob = out + head_of(x, n);
  const bool vec_out = (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
  each_share(
      x, n, gtid, G, [&](long long i, float v) { out[i] = f(v); },
      [&](long long v, const float4& r) {
        const uint4 w = make_uint4(f(r.x), f(r.y), f(r.z), f(r.w));
        if (vec_out) {
          reinterpret_cast<uint4*>(ob)[v] = w;
        } else {
          ob[4 * v] = w.x;
          ob[4 * v + 1] = w.y;
          ob[4 * v + 2] = w.z;
          ob[4 * v + 3] = w.w;
        }
      });
}

// One thread's share of the sum, in the partition's fixed order.  A
// vector's four terms are added in f32 as (x + y) + (z + w) and the sum
// goes to the f64 partial: a quarter of the f32 -> f64 conversions, which
// the card issues at an eighth of its f32 rate.
__device__ __forceinline__ void thread_lg(const float* __restrict__ x,
                                          long long n, long long gtid,
                                          long long G, double& s,
                                          long long& c) {
  each_share(
      x, n, gtid, G,
      [&](long long, float v) {
        int k = 0;
        s += (double)lg_of(v, k);
        c += k;
      },
      [&](long long, const float4& r) {
        int k = 0;
        const float l4 = (lg_of(r.x, k) + lg_of(r.y, k)) +
                         (lg_of(r.z, k) + lg_of(r.w, k));
        s += (double)l4;
        c += k;
      });
}

// Sum of the block's (a, b) by a fixed tree: element t adds t + stride for
// stride = T/2, T/4, ..., 1.  Every thread returns the total.
template <int T, class A, class B>
__device__ __forceinline__ void block_total(A& a, B& b, A* as, B* bs) {
  const int t = threadIdx.x;
  as[t] = a;
  bs[t] = b;
  __syncthreads();
#pragma unroll
  for (int st = T / 2; st > 0; st >>= 1) {
    if (t < st) {
      as[t] += as[t + st];
      bs[t] += bs[t + st];
    }
    __syncthreads();
  }
  a = as[0];
  b = bs[0];
  __syncthreads();
}

// _pow2_scale's last steps: the sum and the count (int64, clamped to 1)
// each become f32 once, then an f32 divide, round-half-even, exp2, clamp.
// The sum is torch's f32 sum taken in f64, so where the mean log2 lies
// within the f32 sum's rounding of a .5 tie the two may round it to
// neighbouring powers of two; the f64 sum is the one nearer the exact mean.
__device__ __forceinline__ float scale_of(double sum, long long count) {
  const float mean = (float)sum / (float)(count > 1 ? count : 1);
  return fmaxf(exp2f(rintf(mean)), 1e-30f);
}

// The consumer launch's s: waits for the reduce grid, then adds its nparts
// partials by the fixed tree (thread t: partials t, t + T, ...).
template <int T>
__device__ __forceinline__ float scale_from_partials(
    const Partial* __restrict__ parts, int nparts, double* ss,
    long long* cs) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  double a = 0.0;
  long long c = 0;
  for (int i = threadIdx.x; i < nparts; i += T) {
    a += parts[i].sum;
    c += parts[i].count;
  }
  block_total<T>(a, c, ss, cs);
  return scale_of(a, c);
}

// v / s as XLA computes it: a subnormal v reads as 0; then by one
// multiply where s is a normal power of two (its exact reciprocal gives
// the same bits), else by IEEE division.
struct Quotient {
  float s, inv;
  bool by_mul;
  __device__ __forceinline__ explicit Quotient(float s_) : s(s_) {
    const uint32_t sb = __float_as_uint(s_);
    const uint32_t se = (sb >> 23) & 0xFFu;
    by_mul = (sb & 0x7FFFFFu) == 0u && se != 0u && se != 0xFFu;
    inv = 1.0f / s_;
  }
  __device__ __forceinline__ float operator()(float v) const {
    v = euler::flush_subnormal(v);
    return by_mul ? v * inv : v / s;
  }
};

// The format's 256 encode entries, one per f32 exponent, in shared memory.
template <int T>
__device__ __forceinline__ void build_table(euler::EncodeEntry* tab,
                                            euler::Posit pc) {
  for (int i = threadIdx.x; i < 256; i += T)
    tab[i] = euler::encode_entry(i, pc);
  __syncthreads();
}

// The format of a launch: (N, ES, R) known when it is compiled, for the
// six formats of the EulerConfig widths (every shift, clamp and regime
// bound then folds to a constant), or read at run time where N == 0.
template <int N, int ES, int R>
__device__ __forceinline__ euler::Posit fmt(euler::Posit run_time) {
  if constexpr (N == 0) {
    return run_time;
  } else {
    return euler::Posit{N, ES, R};
  }
}

// f.template run<N, ES, R>() for one of the six compiled formats (posit
// and b-posit of widths 8, 16 and 32 with es 0, 1, 2 and bounds 2, 3, 5),
// or run<0, 0, 0>() for the run-time one.
template <class F>
int by_format(euler::Posit pc, const F& f) {
  const int N = pc.N, es = pc.es, R = pc.R;
  if (N == 8 && es == 0 && R == 0) return f.template run<8, 0, 0>();
  if (N == 8 && es == 0 && R == 2) return f.template run<8, 0, 2>();
  if (N == 16 && es == 1 && R == 0) return f.template run<16, 1, 0>();
  if (N == 16 && es == 1 && R == 3) return f.template run<16, 1, 3>();
  if (N == 32 && es == 2 && R == 0) return f.template run<32, 2, 0>();
  if (N == 32 && es == 2 && R == 5) return f.template run<32, 2, 5>();
  return f.template run<0, 0, 0>();
}

// Reduce launch: one (sum, count) partial per block.
__global__ void __launch_bounds__(RED_THREADS, BLOCKS_PER_SM)
pe_reduce_kernel(const float* __restrict__ x, long long n,
                 Partial* __restrict__ parts) {
  __shared__ double ss[RED_THREADS];
  __shared__ long long cs[RED_THREADS];
  // the consumer launch may start its blocks as these finish (see
  // launch_dependent); it waits for this grid before it reads the partials
  asm volatile("griddepcontrol.launch_dependents;");
  double s = 0.0;
  long long c = 0;
  thread_lg(x, n, (long long)blockIdx.x * RED_THREADS + threadIdx.x,
            (long long)gridDim.x * RED_THREADS, s, c);
  block_total<RED_THREADS>(s, c, ss, cs);
  if (threadIdx.x == 0) parts[blockIdx.x] = Partial{s, c};
}

inline int launch_reduce(const float* x, long long n, Partial* parts,
                         int blocks, cudaStream_t st) {
  pe_reduce_kernel<<<blocks, RED_THREADS, 0, st>>>(x, n, parts);
  return (int)cudaGetLastError();
}

// kernel<<<blocks, threads, 0, st>>>(args...) as a programmatic dependent
// launch: its blocks are scheduled as the stream's previous launch's
// blocks leave the SMs (or trigger griddepcontrol.launch_dependents), and
// read that launch's results only after griddepcontrol.wait.
template <class... KArgs, class... Args>
int launch_dependent(void (*kernel)(KArgs...), int blocks, int threads,
                     cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
