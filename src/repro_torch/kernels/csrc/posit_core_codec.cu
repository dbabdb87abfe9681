// The core posit codec on the card: the KV-cache words, the guard's
// quantize check and sentinels, out_quant and fault injection.
//
// Replaces no TPU kernel.  The JAX package runs these call sites through
// its core codec, repro/core/posit.py (encode_from_float :195,
// decode_to_float :170, quantize :265), and its guard's _quantize_like
// and sentinel_counts (repro/reliability/guards.py :153, :209), as
// XLA-fused elementwise code; the port's counterpart,
// repro_torch/core/posit.py, is a chain of int64 torch ops (about 90 aten
// ops a call of the encode, 70 of the decode, 150 of quantize).  These
// entries compute the same function in one pass each, bit for bit with
// that chain (kernels/posit_codec.py: store_plain, load_plain,
// quantize_plain, quantize_prescaled_plain, sentinels_plain), and not the
// TPU kernels' decode that posit_decode.cu computes:
//   - a subnormal input encodes to 0, as XLA's flush gives it (the encode
//     is euler::encode_f32, posit_encode.cu's);
//   - NaR decodes to NaN (0x7FC00000, bf16 0x7FC0: torch's NaN fill);
//   - the value is 1 + frac * 2^-W, then times 2^scale, each step rounded
//     in the output dtype as torch rounds it: frac converted to f32 (and
//     then bf16), the sum rounded to f32 (then bf16).  For P32 that is a
//     second rounding where decode_planes rounds 2^W + frac once;
//   - quantize(x / s) * s: a subnormal x reads as 0 and a product below
//     2^-126 is a signed 0 (XLA's flush of the input and of the product).
//
//   posit_store_launch     f32 or bf16 -> words of N bits (uint8 / uint16 /
//                          uint32; torch holds the last two as int16 / int32)
//   posit_load_launch      words -> f32 or bf16
//   posit_quantize_launch  f32 -> f32, quantize(x) (out_quant)
//   posit_quantize_prescaled_launch
//                          f32 -> (quantize(x / s) * s, s), s the pow2
//                          pre-scale of x (IEEE division, the f32
//                          product): the guard's check operand
//   posit_sentinels_launch f32 -> int64 [2]: the NaR words and the
//                          saturated words (regime run at its cap, neither
//                          zero nor NaR) of x / s, or of x: the guard's
//                          sentinels; the words never in memory
//
// Bound on the H100: bytes, as the kernels line counts it, at 3.35 TB/s.
// store and load read their input and write their output once (store: 4
// or 2 B in, N / 8 out; load: N / 8 in, 4 or 2 out): one value a thread in
// a grid-stride loop, neighbouring threads on neighbouring elements, no
// shared memory, no atomics; a K/V write is launch-bound.  The guard's
// two entries read x twice where they pre-scale (the scale needs the
// whole tensor before the first word): quantize 12 B a value (x twice, q
// once), sentinels 8 B; without the scale (quantize is out_quant's
// entry then) 8 and 4 B.  They take
// posit_encode.cu's design (posit_prescale.cuh): the same reduce launch
// and fixed trees, so their s is posit_encode_prescaled's on the same
// tensor, bit for bit (the check quantizes what the cuda base consumed);
// the consumer launch is a programmatic dependent launch that waits for
// the reduce grid, so no host sync and no float atomics; 16-byte loads
// and stores; the encode from the format's table of 256 exponent entries
// in shared memory, the quantize with (N, es, R) compiled as constants
// for the six EulerConfig formats.  The sentinels (the format read at run
// time) classify each word from its body (two compares against the
// format's saturation bounds) and count per thread; each block's counts
// go to an int64 partial, and a one-block launch adds the partials by a
// fixed tree.  PERF.md section 6 has their times beside the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "posit_common.cuh"
#include "posit_prescale.cuh"

namespace {

constexpr int THREADS = 256;

// decode_fields: sign, scale and the W-bit fraction (0 for zero and NaR).
struct Fields {
  uint32_t sign, frac;
  int scale;
  bool zero, nar;
};

__device__ __forceinline__ Fields fields_of(uint32_t pat, euler::Posit pc) {
  const int N = pc.N, es = pc.es, rcap = pc.rcap();
  const uint32_t p = pat & euler::mask32(N);
  Fields f;
  f.sign = (p >> (N - 1)) & 1u;
  f.zero = p == 0u;
  f.nar = p == (1u << (N - 1));
  const uint32_t body = f.sign ? ((0u - p) & euler::mask32(N - 1))
                               : (p & euler::mask32(N - 1));
  // the regime run: leading bits equal to the body's top bit, capped at
  // rcap (as decode_planes counts it)
  const uint32_t r0 = (body >> (N - 2)) & 1u;
  int run = __clz((body ^ (0u - r0)) << (33 - N));
  run = run < rcap ? run : rcap;
  const int rw = run < rcap ? run + 1 : rcap;
  const int k = r0 ? run - 1 : -run;
  const uint32_t rem = (body << rw) & euler::mask32(N - 1);
  int e = 0;
  uint32_t frac = rem;
  if (es > 0) {
    e = (int)(rem >> (N - 1 - es));
    frac = rem & euler::mask32(N - 1 - es);
  }
  const bool special = f.zero || f.nar;
  f.scale = special ? 0 : k * (1 << es) + e;
  f.frac = special ? 0u : frac;
  return f;
}

__device__ __forceinline__ float value_f32(const Fields& f, euler::Posit pc) {
  const float m = __fadd_rn(1.0f, __fmul_rn(__uint2float_rn(f.frac),
                                            euler::pow2(-pc.W())));
  const float v = __fmul_rn(m, euler::pow2(f.scale));
  if (f.nar) return __uint_as_float(0x7FC00000u);
  if (f.zero) return 0.0f;
  return f.sign ? -v : v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ __nv_bfloat16 value_bf16(const Fields& f,
                                                    euler::Posit pc) {
  // torch converts the int64 fraction to f32 and that to bf16, and each
  // bf16 op computes in f32 and rounds its result to bf16
  const float fb = round_bf16(__uint2float_rn(f.frac));
  const float t = round_bf16(__fmul_rn(fb, euler::pow2(-pc.W())));
  const float m = round_bf16(__fadd_rn(1.0f, t));
  const float v = round_bf16(__fmul_rn(m, round_bf16(euler::pow2(f.scale))));
  if (f.nar) return __ushort_as_bfloat16((unsigned short)0x7FC0u);
  if (f.zero) return __ushort_as_bfloat16((unsigned short)0u);
  return __float2bfloat16_rn(f.sign ? -v : v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* out, long long i, const Fields& f,
                                    euler::Posit pc) {
  out[i] = value_f32(f, pc);
}
__device__ __forceinline__ void put(__nv_bfloat16* out, long long i,
                                    const Fields& f, euler::Posit pc) {
  out[i] = value_bf16(f, pc);
}

template <typename In, typename Word>
__global__ void store_kernel(const In* __restrict__ x, Word* __restrict__ out,
                             long long n, euler::Posit pc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = (Word)euler::encode_f32(to_f32(x[i]), pc);
}

template <typename Word, typename Out>
__global__ void load_kernel(const Word* __restrict__ words,
                            Out* __restrict__ out, long long n,
                            euler::Posit pc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    put(out, i, fields_of((uint32_t)words[i], pc), pc);
}

// quantize(x / s) * s with s from the reduce launch's partials (nparts >
// 0; block 0 writes it to s_out), or quantize(x) (nparts == 0).
template <int N, int ES, int R>
__global__ void __launch_bounds__(ENC_THREADS, BLOCKS_PER_SM)
pq_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
          euler::Posit run_time, const Partial* __restrict__ parts,
          int nparts, float* __restrict__ s_out) {
  __shared__ double ss[ENC_THREADS];
  __shared__ long long cs[ENC_THREADS];
  __shared__ euler::EncodeEntry tab[256];
  const euler::Posit pc = fmt<N, ES, R>(run_time);
  build_table<ENC_THREADS>(tab, pc);
  float s = 1.0f;
  if (nparts > 0) {
    s = scale_from_partials<ENC_THREADS>(parts, nparts, ss, cs);
    if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  }
  const bool scaled = nparts > 0;
  const Quotient div(s);
  map_share(x, reinterpret_cast<uint32_t*>(out), n,
            (long long)blockIdx.x * ENC_THREADS + threadIdx.x,
            (long long)gridDim.x * ENC_THREADS, [&](float v) {
              const uint32_t b = __float_as_uint(scaled ? div(v) : v);
              const uint32_t w =
                  euler::encode_by_entry(b, tab[(b >> 23) & 0xFFu], pc);
              const float q = value_f32(fields_of(w, pc), pc);
              return __float_as_uint(
                  scaled ? euler::flush_subnormal(__fmul_rn(q, s)) : q);
            });
}

// The NaR and saturated words of x / s (s from the partials, nparts > 0)
// or of x: each block's two counts to counts[2 * block].  A word is NaR
// where the f32 exponent field is 255, zero where it is 0 (zero and
// subnormals); any other word is saturated where its body's regime run
// reaches rcap: its top rcap bits all ones (body >= hi) or all zeros
// (body < lo).  The format is read at run time: the sentinels count a
// contraction's output, where the launches, not the instructions, set the
// time, and its six compiled formats cost nvcc about 30 s.
__global__ void __launch_bounds__(ENC_THREADS, BLOCKS_PER_SM)
ps_kernel(const float* __restrict__ x, long long n, euler::Posit pc,
          const Partial* __restrict__ parts, int nparts,
          long long* __restrict__ counts) {
  __shared__ double ss[ENC_THREADS];
  __shared__ long long cs[ENC_THREADS], ns[ENC_THREADS];
  __shared__ euler::EncodeEntry tab[256];
  // the totals launch may place its block while these run
  asm volatile("griddepcontrol.launch_dependents;");
  build_table<ENC_THREADS>(tab, pc);
  float s = 1.0f;
  if (nparts > 0)
    s = scale_from_partials<ENC_THREADS>(parts, nparts, ss, cs);
  const bool scaled = nparts > 0;
  const Quotient div(s);
  const int run_bits = pc.N - 1 - pc.rcap();
  const uint32_t hi = euler::mask32(pc.rcap()) << run_bits;
  const uint32_t lo = 1u << run_bits;
  int nar = 0, sat = 0;
  auto count = [&](float v) {
    const uint32_t b = __float_as_uint(scaled ? div(v) : v);
    const uint32_t e8 = (b >> 23) & 0xFFu;
    const uint32_t body = euler::body_by_entry(b, tab[e8], pc);
    nar += e8 == 0xFFu;
    sat += e8 != 0u && e8 != 0xFFu && (body >= hi || body < lo);
  };
  each_share(
      x, n, (long long)blockIdx.x * ENC_THREADS + threadIdx.x,
      (long long)gridDim.x * ENC_THREADS,
      [&](long long, float v) { count(v); },
      [&](long long, const float4& r) {
        count(r.x);
        count(r.y);
        count(r.z);
        count(r.w);
      });
  long long a = nar, c = sat;
  block_total<ENC_THREADS>(a, c, ns, cs);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = a;
    counts[2 * blockIdx.x + 1] = c;
  }
}

// The blocks' counts added by a fixed tree into out[0] (NaR) and out[1]
// (saturated).
__global__ void __launch_bounds__(ENC_THREADS)
ps_total_kernel(const long long* __restrict__ counts, int blocks,
                long long* __restrict__ out) {
  __shared__ long long as[ENC_THREADS], bs[ENC_THREADS];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  long long a = 0, b = 0;
  for (int i = threadIdx.x; i < blocks; i += ENC_THREADS) {
    a += counts[2 * i];
    b += counts[2 * i + 1];
  }
  block_total<ENC_THREADS>(a, b, as, bs);
  if (threadIdx.x == 0) {
    out[0] = a;
    out[1] = b;
  }
}

// kernel<<<blocks, ENC_THREADS>>>(args...): a programmatic dependent
// launch after a reduce launch (the kernel waits for it before it reads
// the partials), else an ordinary one (a kernel that never waits must not
// start before the stream's earlier work is done).
template <class... KArgs, class... Args>
int launch_consumer(bool after_reduce, void (*kernel)(KArgs...), int blocks,
                    cudaStream_t st, Args... args) {
  if (after_reduce)
    return launch_dependent(kernel, blocks, ENC_THREADS, st, args...);
  kernel<<<blocks, ENC_THREADS, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

// The reduce launch where reduce_blocks > 0, then the quantize launch.
struct QuantizeLaunch {
  const float* x;
  float* out;
  float* s_out;
  Partial* parts;
  long long n;
  euler::Posit pc;
  int reduce_blocks, blocks;
  cudaStream_t st;
  template <int N, int ES, int R>
  int run() const {
    const bool reduce = reduce_blocks > 0;
    if (reduce) {
      const int err = launch_reduce(x, n, parts, reduce_blocks, st);
      if (err != 0) return err;
    }
    return launch_consumer(reduce, pq_kernel<N, ES, R>, blocks, st, x, out,
                           n, pc, (const Partial*)parts, reduce_blocks,
                           s_out);
  }
};

template <typename In>
int store_as(const In* x, void* out, long long n, euler::Posit pc,
             int blocks, cudaStream_t st) {
  switch (pc.N) {
    case 8:
      store_kernel<<<blocks, THREADS, 0, st>>>(x, (uint8_t*)out, n, pc);
      break;
    case 16:
      store_kernel<<<blocks, THREADS, 0, st>>>(x, (uint16_t*)out, n, pc);
      break;
    case 32:
      store_kernel<<<blocks, THREADS, 0, st>>>(x, (uint32_t*)out, n, pc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Out>
int load_as(const void* words, Out* out, long long n, euler::Posit pc,
            int blocks, cudaStream_t st) {
  switch (pc.N) {
    case 8:
      load_kernel<<<blocks, THREADS, 0, st>>>((const uint8_t*)words, out, n,
                                              pc);
      break;
    case 16:
      load_kernel<<<blocks, THREADS, 0, st>>>((const uint16_t*)words, out, n,
                                              pc);
      break;
    case 32:
      load_kernel<<<blocks, THREADS, 0, st>>>((const uint32_t*)words, out, n,
                                              pc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int posit_store_launch(const void* x, int x_bf16, void* out,
                                  long long n, int N, int es, int R,
                                  int blocks, void* stream) {
  if (n <= 0) return 0;
  const euler::Posit pc{N, es, R};
  const cudaStream_t st = (cudaStream_t)stream;
  return x_bf16 ? store_as((const __nv_bfloat16*)x, out, n, pc, blocks, st)
                : store_as((const float*)x, out, n, pc, blocks, st);
}

extern "C" int posit_load_launch(const void* words, void* out, int out_bf16,
                                 long long n, int N, int es, int R,
                                 int blocks, void* stream) {
  if (n <= 0) return 0;
  const euler::Posit pc{N, es, R};
  const cudaStream_t st = (cudaStream_t)stream;
  return out_bf16 ? load_as(words, (__nv_bfloat16*)out, n, pc, blocks, st)
                  : load_as(words, (float*)out, n, pc, blocks, st);
}

// quantize(x).
extern "C" int posit_quantize_launch(const float* x, float* out, long long n,
                                     int N, int es, int R, int blocks,
                                     void* stream) {
  if (n <= 0) return 0;
  const euler::Posit pc{N, es, R};
  return by_format(pc, QuantizeLaunch{x, out, nullptr, nullptr, n, pc, 0,
                                      blocks, (cudaStream_t)stream});
}

// (quantize(x / s) * s, s) with s the pow2 pre-scale of x: the reduce
// launch (reduce_blocks partials of 16 bytes in partials), then the
// quantize launch; s to s_out.
extern "C" int posit_quantize_prescaled_launch(
    const float* x, float* out, float* s_out, void* partials, long long n,
    int N, int es, int R, int reduce_blocks, int blocks, void* stream) {
  const euler::Posit pc{N, es, R};
  return by_format(pc, QuantizeLaunch{x, out, s_out,
                                      reinterpret_cast<Partial*>(partials),
                                      n, pc, reduce_blocks, blocks,
                                      (cudaStream_t)stream});
}

// The (NaR, saturated) word counts of x / s (reduce_blocks > 0: s the pow2
// pre-scale, the partials in partials) or of x (reduce_blocks == 0) into
// out[2]: the reduce launch, the counting launch (counts holds [blocks][2]
// int64 partials), then the totals launch, a programmatic dependent
// launch that waits for the counts.
extern "C" int posit_sentinels_launch(const float* x, void* partials,
                                      long long* counts, long long* out,
                                      long long n, int N, int es, int R,
                                      int reduce_blocks, int blocks,
                                      void* stream) {
  const euler::Posit pc{N, es, R};
  const cudaStream_t st = (cudaStream_t)stream;
  Partial* parts = reinterpret_cast<Partial*>(partials);
  const bool reduce = reduce_blocks > 0;
  if (reduce) {
    const int err = launch_reduce(x, n, parts, reduce_blocks, st);
    if (err != 0) return err;
  }
  const int err = launch_consumer(reduce, ps_kernel, blocks, st, x, n, pc,
                                  (const Partial*)parts, reduce_blocks,
                                  counts);
  if (err != 0) return err;
  return launch_dependent(ps_total_kernel, 1, ENC_THREADS, st,
                          (const long long*)counts, blocks, out);
}
