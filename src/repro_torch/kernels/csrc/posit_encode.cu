// Posit encode kernels: f32 -> posit pattern, and the fused "pow2 pre-scale
// + encode" pass that the cuda backend's contractions run.
//
// Replaces the TPU kernel repro/kernels/posit_codec.py:73 _encode_kernel
// (pl.pallas_call at :91, entry posit_encode :103), and, for the fused
// entry, the per-tensor scale repro/core/engine.py:135 _pow2_scale that the
// JAX backend computes before it (backends.py, fused by XLA on a TPU).  The
// function is euler::encode_f32, a line-for-line counterpart of
// encode_body, computed as euler::encode_by_entry from a table of the
// format's 256 f32 exponents that each block builds in shared memory.
//
// Bound on the H100: bytes.  The plain entry reads 4 bytes and writes 4
// bytes a value; the fused entry reads x twice (the scale needs the whole
// tensor before the first word) and writes 4 bytes, 12 bytes a value at
// 3.35 TB/s.  What the design does about it:
//   - 16-byte loads and stores (float4 / uint4), UNROLL loads a thread at
//     a time, the next UNROLL in flight while the current ones are worked;
//   - integer instructions: the card issues 64 a clock on an SM, about 70
//     a value of encode_f32 would hold it at under two thirds of its byte
//     rate; the table leaves about twenty, and each format the
//     EulerConfig widths use is compiled with its (N, es, R) as constants.
//
// The partition (kernels/posit_codec.py: _encode_plan mirrors it): the
// first `head` values, up to x's first 16-byte boundary, go one to a
// thread; then float4 vectors in a grid-stride loop; then the last
// (n - head) % 4 values, one to a thread.  Where the words' base is not
// 16-byte aligned with x's, the vector loop stores its four words singly.
//
// The fused entry computes s = max(2^rint(sum lg / max(count, 1)), 1e-30)
// over lg = log2(max(|x|, 1e-38)) of the values with |x| > 0 (NaN is not
// counted), exactly the steps of _pow2_scale, then encodes x / s:
//   reduce launch  (large x): a fixed grid; each thread sums its share in
//     f64 with an exact int64 count, each block adds its threads' sums by
//     a fixed tree into one partial of a [blocks] scratch;
//   encode launch (a programmatic dependent launch): every block builds
//     its table, waits for the reduce grid, adds the partials by the same
//     fixed tree, so all blocks get the same s without a third launch or a
//     host sync; block 0 writes s; then each block encodes its share.
// The plain entry is the encode launch alone, with s = 1.
// The split entry is for a tensor whose rows are split over a group of
// ranks (data parallel): posit_encode_reduce runs the reduce launch alone,
// the caller sums the (sum, count) partials over the group, and
// posit_encode_from_partials runs the encode launch on the summed
// partials, so every rank encodes with the scale of the whole tensor.
// No float atomics: two launches on the same input give the same bits.
// Division is IEEE (no --use_fast_math); where s is a normal power of two
// the exact reciprocal gives the same bits by one multiply.
#include <cuda_runtime.h>
#include <stdint.h>
#include "posit_common.cuh"

constexpr int ENC_THREADS = 256;
constexpr int RED_THREADS = 256;
constexpr int UNROLL = 4;
// blocks of the encode and reduce launches resident on an SM (at most 64
// registers a thread); the plan caps both grids at one such wave
constexpr int BLOCKS_PER_SM = 4;

struct Partial {
  double sum;
  long long count;
};

// Values before x's first 16-byte boundary (x is 4-byte aligned).
__device__ __forceinline__ long long head_of(const float* x, long long n) {
  long long h = (long long)((16 - ((uintptr_t)x & 15)) & 15) >> 2;
  return h < n ? h : n;
}

// log2(max(|v|, 1e-38)) where |v| > 0 (counted in c), else 0.
__device__ __forceinline__ float lg_of(float v, int& c) {
  const float a = fabsf(v);
  const bool nz = a > 0.0f;
  c += nz;
  return nz ? log2f(fmaxf(a, 1e-38f)) : 0.0f;
}

__device__ __forceinline__ void add_lg(float v, double& s, long long& c) {
  int k = 0;
  s += (double)lg_of(v, k);
  c += k;
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

// One thread's share of the sum, in the partition's fixed order: its head
// value, its vectors in ascending order, its tail value.  A vector's four
// terms are added in f32 as (x + y) + (z + w) and the sum goes to the f64
// partial: a quarter of the f32 -> f64 conversions, which the card issues
// at an eighth of its f32 rate.
__device__ __forceinline__ void thread_lg(const float* __restrict__ x,
                                          long long n, long long gtid,
                                          long long G, double& s,
                                          long long& c) {
  const long long h = head_of(x, n);
  if (gtid < h) add_lg(x[gtid], s, c);
  const long long nv = (n - h) >> 2;
  each_vector(reinterpret_cast<const float4*>(x + h), nv, gtid, G,
              [&](long long, const float4& r) {
                int k = 0;
                const float l4 = (lg_of(r.x, k) + lg_of(r.y, k)) +
                                 (lg_of(r.z, k) + lg_of(r.w, k));
                s += (double)l4;
                c += k;
              });
  const long long t0 = h + 4 * nv;
  if (gtid < n - t0) add_lg(x[t0 + gtid], s, c);
}

// Sum of the block's (s, c) by a fixed tree: element t adds t + stride for
// stride = T/2, T/4, ..., 1.  Every thread returns the total.
template <int T>
__device__ __forceinline__ void block_total(double& s, long long& c,
                                            double* ss, long long* cs) {
  const int t = threadIdx.x;
  ss[t] = s;
  cs[t] = c;
  __syncthreads();
#pragma unroll
  for (int st = T / 2; st > 0; st >>= 1) {
    if (t < st) {
      ss[t] += ss[t + st];
      cs[t] += cs[t + st];
    }
    __syncthreads();
  }
  s = ss[0];
  c = cs[0];
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

// The format's 256 encode entries, one per f32 exponent, in shared memory.
template <int T>
__device__ __forceinline__ void build_table(euler::EncodeEntry* tab,
                                            euler::Posit pc) {
  for (int i = threadIdx.x; i < 256; i += T)
    tab[i] = euler::encode_entry(i, pc);
  __syncthreads();
}

// Encode x / s over one thread's share of the partition.
__device__ __forceinline__ void encode_share(
    const float* __restrict__ x, uint32_t* __restrict__ out, long long n,
    euler::Posit pc, const euler::EncodeEntry* tab, float s, long long gtid,
    long long G) {
  const uint32_t sb = __float_as_uint(s);
  const uint32_t se = (sb >> 23) & 0xFFu;
  // a normal power of two has an exact reciprocal: x * (1/s) == x / s
  const bool by_mul = (sb & 0x7FFFFFu) == 0u && se != 0u && se != 0xFFu;
  const float inv = 1.0f / s;
  auto enc = [&](float v) {
    const uint32_t b = __float_as_uint(by_mul ? v * inv : v / s);
    return euler::encode_by_entry(b, tab[(b >> 23) & 0xFFu], pc);
  };
  const long long h = head_of(x, n);
  if (gtid < h) out[gtid] = enc(x[gtid]);
  const long long nv = (n - h) >> 2;
  uint32_t* ob = out + h;
  const bool vec_out = (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
  each_vector(reinterpret_cast<const float4*>(x + h), nv, gtid, G,
              [&](long long v, const float4& r) {
                const uint4 w = make_uint4(enc(r.x), enc(r.y), enc(r.z),
                                           enc(r.w));
                if (vec_out) {
                  reinterpret_cast<uint4*>(ob)[v] = w;
                } else {
                  ob[4 * v] = w.x;
                  ob[4 * v + 1] = w.y;
                  ob[4 * v + 2] = w.z;
                  ob[4 * v + 3] = w.w;
                }
              });
  const long long t0 = h + 4 * nv;
  if (gtid < n - t0) out[t0 + gtid] = enc(x[t0 + gtid]);
}

// The format of a launch: (N, ES, R) known when it is compiled, for the
// six formats of the EulerConfig widths (every shift, clamp and regime
// bound of encode_f32 then folds to a constant), or read at run time
// where N == 0.
template <int N, int ES, int R>
__device__ __forceinline__ euler::Posit fmt(euler::Posit run_time) {
  if constexpr (N == 0) {
    return run_time;
  } else {
    return euler::Posit{N, ES, R};
  }
}

// Reduce launch: one (sum, count) partial per block.
__global__ void __launch_bounds__(RED_THREADS, BLOCKS_PER_SM)
pe_reduce_kernel(const float* __restrict__ x, long long n,
                 Partial* __restrict__ parts) {
  __shared__ double ss[RED_THREADS];
  __shared__ long long cs[RED_THREADS];
  // the encode launch may start its blocks as these finish (see launch);
  // it waits for this grid before it reads the partials
  asm volatile("griddepcontrol.launch_dependents;");
  double s = 0.0;
  long long c = 0;
  thread_lg(x, n, (long long)blockIdx.x * RED_THREADS + threadIdx.x,
            (long long)gridDim.x * RED_THREADS, s, c);
  block_total<RED_THREADS>(s, c, ss, cs);
  if (threadIdx.x == 0) parts[blockIdx.x] = Partial{s, c};
}

// Encode launch: s from the partials, written to s_out by block 0 (nparts ==
// 0, the plain entry: s = 1 and s_out is not touched), then the words.
template <int N, int ES, int R>
__global__ void __launch_bounds__(ENC_THREADS, BLOCKS_PER_SM)
pe_encode_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                 long long n, euler::Posit run_time,
                 const Partial* __restrict__ parts, int nparts,
                 float* __restrict__ s_out) {
  __shared__ double ss[ENC_THREADS];
  __shared__ long long cs[ENC_THREADS];
  __shared__ euler::EncodeEntry tab[256];
  const euler::Posit pc = fmt<N, ES, R>(run_time);
  build_table<ENC_THREADS>(tab, pc);
  float s = 1.0f;
  if (nparts > 0) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    double a = 0.0;
    long long c = 0;
    for (int i = threadIdx.x; i < nparts; i += ENC_THREADS) {
      a += parts[i].sum;
      c += parts[i].count;
    }
    block_total<ENC_THREADS>(a, c, ss, cs);
    s = scale_of(a, c);
    if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  }
  encode_share(x, out, n, pc, tab, s,
               (long long)blockIdx.x * ENC_THREADS + threadIdx.x,
               (long long)gridDim.x * ENC_THREADS);
}

struct EncodeArgs {
  const float* x;
  uint32_t* out;
  float* s_out;
  Partial* parts;
  long long n;
  euler::Posit pc;
  int reduce_blocks, encode_blocks;
  int nparts;  // partials already in parts (reduce_blocks == 0 only)
  cudaStream_t st;
};

// With reduce_blocks > 0, the reduce launch then the encode launch on its
// partials; else the encode launch alone, on the nparts partials already
// in parts (nparts == 0: s = 1).
template <int N, int ES, int R>
int launch(const EncodeArgs& a) {
  if (a.reduce_blocks == 0) {
    pe_encode_kernel<N, ES, R><<<a.encode_blocks, ENC_THREADS, 0, a.st>>>(
        a.x, a.out, a.n, a.pc, a.parts, a.nparts, a.s_out);
    return (int)cudaGetLastError();
  }
  pe_reduce_kernel<<<a.reduce_blocks, RED_THREADS, 0, a.st>>>(a.x, a.n,
                                                              a.parts);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // programmatic dependent launch: the encode blocks are scheduled as the
  // reduce blocks leave the SMs and build their tables while the last ones
  // run, instead of after the whole grid and a launch gap
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.encode_blocks);
  cfg.blockDim = dim3(ENC_THREADS);
  cfg.stream = a.st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, pe_encode_kernel<N, ES, R>, a.x,
                                 a.out, a.n, a.pc,
                                 (const Partial*)a.parts, a.reduce_blocks,
                                 a.s_out);
}

// The launch for the format: one of the six compiled formats (posit and
// b-posit of widths 8, 16 and 32 with es 0, 1, 2 and bounds 2, 3, 5), or
// the run-time one.
static int launch_format(const EncodeArgs& a) {
  const int N = a.pc.N, es = a.pc.es, R = a.pc.R;
  if (N == 8 && es == 0 && R == 0) return launch<8, 0, 0>(a);
  if (N == 8 && es == 0 && R == 2) return launch<8, 0, 2>(a);
  if (N == 16 && es == 1 && R == 0) return launch<16, 1, 0>(a);
  if (N == 16 && es == 1 && R == 3) return launch<16, 1, 3>(a);
  if (N == 32 && es == 2 && R == 0) return launch<32, 2, 0>(a);
  if (N == 32 && es == 2 && R == 5) return launch<32, 2, 5>(a);
  return launch<0, 0, 0>(a);
}

// reduce_blocks == 0 is the plain entry (s = 1; s_out and partials are
// not touched), else the fused pre-scale + encode.
extern "C" int posit_encode_launch(const float* x, uint32_t* out, float* s_out,
                                   void* partials, long long n, int N, int es,
                                   int R, int reduce_blocks, int encode_blocks,
                                   void* stream) {
  return launch_format(EncodeArgs{
      x, out, s_out, reinterpret_cast<Partial*>(partials), n,
      euler::Posit{N, es, R}, reduce_blocks, encode_blocks, 0,
      (cudaStream_t)stream});
}

// The split entry, first half: the reduce launch alone, one (f64 sum,
// int64 count) partial per block into partials.
extern "C" int posit_encode_reduce(const float* x, void* partials,
                                   long long n, int reduce_blocks,
                                   void* stream) {
  pe_reduce_kernel<<<reduce_blocks, RED_THREADS, 0, (cudaStream_t)stream>>>(
      x, n, reinterpret_cast<Partial*>(partials));
  return (int)cudaGetLastError();
}

// The split entry, second half: the encode launch on nparts >= 1 partials
// (after the stream's earlier work, so without a dependent launch: the
// encode kernel's wait returns at once); block 0 writes s to s_out.
extern "C" int posit_encode_from_partials(const float* x, uint32_t* out,
                                          float* s_out, void* partials,
                                          int nparts, long long n, int N,
                                          int es, int R, int encode_blocks,
                                          void* stream) {
  return launch_format(EncodeArgs{
      x, out, s_out, reinterpret_cast<Partial*>(partials), n,
      euler::Posit{N, es, R}, 0, encode_blocks, nparts,
      (cudaStream_t)stream});
}
