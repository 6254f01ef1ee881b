// Triangular pair-slot decode: block-local slot t and block size n ->
// (i, j), the row-major strictly-upper-triangular pair of the block.
//
// Replaces the TPU kernel tri_decode_pallas (src/repro/kernels/pairs/
// pairs.py:61). The search is `steps` rounds of an exact binary search for
// the largest row i with cum(i) = i*(n-1) - i*(i-1)/2 <= t, in uint32 as on
// the TPU: row products reach 65533*65534 < 2**32, which overflows int32.
// Lanes with n < 2 produce garbage (the same garbage as the TPU kernel,
// since every operation wraps mod 2**32 identically); callers mask them.
//
// Bound on the H100: 16 bytes a slot (two int32 in, two out) against about
// a dozen integer operations per search step, so it is memory-bound. One
// thread per slot, coalesced int32 loads and stores, everything else in
// registers.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tri_decode_kernel(const int32_t* __restrict__ local,
                                  const int32_t* __restrict__ size,
                                  int32_t* __restrict__ out_i,
                                  int32_t* __restrict__ out_j,
                                  long long count, int steps) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  const uint32_t t = (uint32_t)local[k];
  const uint32_t n = (uint32_t)size[k];
  const uint32_t nm1 = n - 1u;
  uint32_t lo = 0u;
  uint32_t hi = n >= 2u ? n - 2u : 0u;
  for (int s = 0; s < steps; ++s) {
    const uint32_t mid = (lo + hi + 1u) / 2u;
    const uint32_t cum = mid * nm1 - (mid * (mid - 1u)) / 2u;
    const bool go_right = cum <= t;
    lo = go_right ? mid : lo;
    hi = go_right ? hi : mid - 1u;
  }
  const uint32_t i = lo;
  const uint32_t cum_i = i * nm1 - (i * (i - 1u)) / 2u;
  out_i[k] = (int32_t)i;
  out_j[k] = (int32_t)(t - cum_i + i + 1u);
}

extern "C" int tri_decode_launch(const void* local, const void* size,
                                 void* out_i, void* out_j, long long count,
                                 int steps, void* stream) {
  if (count > 0) {
    const int threads = 256;
    const long long blocks = (count + threads - 1) / threads;
    tri_decode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)local, (const int32_t*)size, (int32_t*)out_i,
        (int32_t*)out_j, count, steps);
  }
  return (int)cudaGetLastError();
}
