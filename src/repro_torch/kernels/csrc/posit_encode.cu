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
// The partition, the reduce launch and the scale are posit_prescale.cuh's,
// which posit_core_codec.cu's guard entries share (the same s, bit for
// bit, on the same tensor):
//   reduce launch  (large x): one (f64 sum, int64 count) partial a block;
//   encode launch (a programmatic dependent launch): every block builds
//     its table, waits for the reduce grid, adds the partials by the same
//     fixed tree; block 0 writes s; then each block encodes its share.
// Where the words' base is not 16-byte aligned with x's, the vector loop
// stores its four words singly.
// The plain entry is the encode launch alone, with s = 1.
// The split entry is for a tensor whose rows are split over a group of
// ranks (data parallel): posit_encode_reduce runs the reduce launch alone,
// the caller sums the (sum, count) partials over the group, and
// posit_encode_from_partials runs the encode launch on the summed
// partials, so every rank encodes with the scale of the whole tensor.
// Division is IEEE (no --use_fast_math); where s is a normal power of two
// the exact reciprocal gives the same bits by one multiply.
#include <cuda_runtime.h>
#include <stdint.h>
#include "posit_common.cuh"
#include "posit_prescale.cuh"

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
    s = scale_from_partials<ENC_THREADS>(parts, nparts, ss, cs);
    if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  }
  const Quotient q(s);
  map_share(x, out, n, (long long)blockIdx.x * ENC_THREADS + threadIdx.x,
            (long long)gridDim.x * ENC_THREADS, [&](float v) {
              const uint32_t b = __float_as_uint(q(v));
              return euler::encode_by_entry(b, tab[(b >> 23) & 0xFFu], pc);
            });
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
struct EncodeLaunch {
  EncodeArgs a;
  template <int N, int ES, int R>
  int run() const {
    if (a.reduce_blocks == 0) {
      pe_encode_kernel<N, ES, R><<<a.encode_blocks, ENC_THREADS, 0, a.st>>>(
          a.x, a.out, a.n, a.pc, a.parts, a.nparts, a.s_out);
      return (int)cudaGetLastError();
    }
    const int err = launch_reduce(a.x, a.n, a.parts, a.reduce_blocks, a.st);
    if (err != 0) return err;
    // the encode blocks are scheduled as the reduce blocks leave the SMs
    // and build their tables while the last ones run, instead of after the
    // whole grid and a launch gap
    return launch_dependent(pe_encode_kernel<N, ES, R>, a.encode_blocks,
                            ENC_THREADS, a.st, a.x, a.out, a.n, a.pc,
                            (const Partial*)a.parts, a.reduce_blocks,
                            a.s_out);
  }
};

static int launch_format(const EncodeArgs& a) {
  return by_format(a.pc, EncodeLaunch{a});
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
  return launch_reduce(x, n, reinterpret_cast<Partial*>(partials),
                       reduce_blocks, (cudaStream_t)stream);
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
