// Posit encode kernel: f32 -> posit pattern, one thread per element.
//
// Replaces the TPU kernel repro/kernels/posit_codec.py:73 _encode_kernel
// (pl.pallas_call at :91, entry posit_encode :103).  The body is
// euler::encode_f32, a line-for-line counterpart of encode_body.
//
// Bound on the H100: bytes.  Each element reads 4 bytes and writes 4 bytes
// and does a few dozen integer operations, far below the card's ALU rate,
// so the kernel is bounded by device-memory bandwidth (3.35 TB/s).  The
// grid-stride loop gives neighbouring threads neighbouring words, so every
// load and store is coalesced.
#include <cuda_runtime.h>
#include "posit_common.cuh"

__global__ void posit_encode_kernel(const float* __restrict__ x,
                                    uint32_t* __restrict__ out, long long n,
                                    euler::Posit pc) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = euler::encode_f32(x[i], pc);
  }
}

extern "C" int posit_encode_launch(const float* x, uint32_t* out, long long n,
                                   int N, int es, int R, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  euler::Posit pc{N, es, R};
  posit_encode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, n, pc);
  return (int)cudaGetLastError();
}
