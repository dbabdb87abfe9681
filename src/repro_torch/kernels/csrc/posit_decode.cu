// Posit decode kernel: posit pattern -> f32, one thread per word.
//
// Replaces the TPU kernel repro/kernels/posit_codec.py:77 _decode_kernel
// (pl.pallas_call at :91, entry posit_decode :109).  The body is
// euler::decode_planes with stages 0 and no truncation, keeping only the
// val plane: the counterpart of decode_planes_raw(pat, pc, 0, None, None).
// Zero and NaR decode to 0.0, as in the TPU kernel (the core codec's
// decode_to_float gives NaN for NaR; this kernel is not that function).
//
// Bound on the H100: bytes.  Each word reads 4 bytes and writes 4 bytes;
// the regime scan is at most rcap (<= 31) shift-and-compare steps, far
// below the card's integer rate, so device-memory bandwidth (3.35 TB/s)
// bounds it.  The grid-stride loop gives neighbouring threads neighbouring
// words, so every load and store is coalesced.
#include <cuda_runtime.h>
#include "posit_common.cuh"

__global__ void posit_decode_kernel(const uint32_t* __restrict__ pat,
                                    float* __restrict__ out, long long n,
                                    euler::Posit pc) {
  const euler::Planes pl{0, -1};
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v, r;
    euler::decode_planes(pat[i], pc, pl, &v, &r);
    out[i] = v;
  }
}

extern "C" int posit_decode_launch(const uint32_t* pat, float* out,
                                   long long n, int N, int es, int R,
                                   void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  euler::Posit pc{N, es, R};
  posit_decode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pat, out, n, pc);
  return (int)cudaGetLastError();
}
