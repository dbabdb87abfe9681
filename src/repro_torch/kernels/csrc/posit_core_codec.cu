// The core posit codec on the card: the KV-cache words, the guard's
// quantize check and sentinels, out_quant and fault injection.
//
// Replaces no TPU kernel.  The JAX package runs these call sites through
// its core codec, repro/core/posit.py (encode_from_float :195,
// decode_to_float :170, quantize :265), as XLA-fused elementwise code; the
// port's counterpart, repro_torch/core/posit.py, is a chain of int64 torch
// ops (about 90 aten ops a call of the encode, 70 of the decode, 150 of
// quantize).  These entries compute the same function in one launch each,
// bit for bit with that chain (kernels/posit_codec.py: store_plain,
// load_plain, quantize_plain), and not the TPU kernels' function that
// posit_encode.cu and posit_decode.cu compute:
//   - a subnormal input encodes to +-minpos (every format's smallest scale
//     is >= -126, so a subnormal lies below minpos); encode_f32 flushes it
//     to 0;
//   - NaR decodes to NaN (0x7FC00000, bf16 0x7FC0: torch's NaN fill);
//   - the value is 1 + frac * 2^-W, then times 2^scale, each step rounded
//     in the output dtype as torch rounds it: frac converted to f32 (and
//     then bf16), the sum rounded to f32 (then bf16).  For P32 that is a
//     second rounding where decode_planes rounds 2^W + frac once.
//
//   posit_store_launch     f32 or bf16 -> words of N bits (uint8 / uint16 /
//                          uint32; torch holds the last two as int16 / int32)
//   posit_load_launch      words -> f32 or bf16
//   posit_quantize_launch  f32 -> f32, quantize(x / s) * s (IEEE division,
//                          the f32 product) or quantize(x) where s is null;
//                          the words stay in registers
//
// Bound on the H100: bytes, as the kernels line counts it.  A value reads
// its input and writes its output once (store: 4 or 2 B in, N / 8 out;
// load: N / 8 in, 4 or 2 out; quantize: 8 B), at 3.35 TB/s.  What holds
// them is their integer instructions: the encode is about 70 a value
// (posit_encode.cu's count), the decode a few tens more, against the 64 a
// clock an SM issues; PERF.md section 6 has their times beside the bound.
// The design is the simple one: one value a thread in a grid-stride loop,
// neighbouring threads on neighbouring elements, so every load and store
// is coalesced; no shared memory, no atomics.  The encode's table form
// (posit_encode.cu) would cut its instructions; that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "posit_common.cuh"

namespace {

constexpr int THREADS = 256;

// f32 -> pattern, the core codec's encode_from_float.
__device__ __forceinline__ uint32_t encode_core(float x, euler::Posit pc) {
  const uint32_t bits = __float_as_uint(x);
  if ((bits & 0x7F800000u) == 0u && (bits & 0x007FFFFFu) != 0u)
    return (bits >> 31) ? euler::mask32(pc.N) : 1u;  // -minpos : minpos
  return euler::encode_f32(x, pc);
}

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
    out[i] = (Word)encode_core(to_f32(x[i]), pc);
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

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ s,
                                float* __restrict__ out, long long n,
                                euler::Posit pc) {
  const float sv = s ? *s : 1.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = s ? __fdiv_rn(x[i], sv) : x[i];
    const float q = value_f32(fields_of(encode_core(v, pc), pc), pc);
    out[i] = s ? __fmul_rn(q, sv) : q;
  }
}

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

extern "C" int posit_quantize_launch(const float* x, const float* s,
                                     float* out, long long n, int N, int es,
                                     int R, int blocks, void* stream) {
  if (n <= 0) return 0;
  const euler::Posit pc{N, es, R};
  quantize_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, s, out, n,
                                                                pc);
  return (int)cudaGetLastError();
}
