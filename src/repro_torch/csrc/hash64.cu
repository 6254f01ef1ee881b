// Bulk 64-bit key hashing on u64 values held as int64 bit patterns:
//   mix64:     the splitmix64 finalizer, elementwise;
//   combine64: the order-canonical combine of two keys (HDB Alg. 2 line 7),
//              lo = min_u64(a, b), hi = the other key,
//              out = mix64((mix64(lo) ^ rotl(hi, 29)) + GAMMA).
//
// Replaces the TPU kernels mix64_pallas and combine64_pallas
// (src/repro/kernels/hash64/hash64.py:62 and :55), which ran the chain on
// uint32 limb pairs because the TPU has no 64-bit lanes. Here the chain is
// plain uint64_t arithmetic: unsigned shifts are logical and unsigned
// compares give min_u64 directly.
//
// Bound on the H100: 16 bytes a key for mix64 (8 in, 8 out) and 24 for
// combine64 (16 in, 8 out) against about a dozen 64-bit integer operations,
// so both are memory-bound. One thread per element in a grid-stride loop
// (counts reach 90M keys on the main path), coalesced 8-byte loads and
// stores, the chain in registers.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= kM1;
  x ^= x >> 27;
  x *= kM2;
  return x ^ (x >> 31);
}

__global__ void mix64_kernel(const uint64_t* __restrict__ x,
                             uint64_t* __restrict__ out, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < count; k += stride) {
    out[k] = mix64(x[k]);
  }
}

__global__ void combine64_kernel(const uint64_t* __restrict__ a,
                                 const uint64_t* __restrict__ b,
                                 uint64_t* __restrict__ out, long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < count; k += stride) {
    const uint64_t ak = a[k];
    const uint64_t bk = b[k];
    // the reference's where(lt(a, b), a, b) and where(lo == a, b, a):
    // with a == b both keys are b
    const uint64_t lo = ak < bk ? ak : bk;
    const uint64_t hi = lo == ak ? bk : ak;
    const uint64_t h = mix64(lo) ^ ((hi << 29) | (hi >> 35));
    out[k] = mix64(h + kGamma);
  }
}

static unsigned grid_for(long long count) {
  long long blocks = (count + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

extern "C" int mix64_launch(const void* x, void* out, long long count,
                            void* stream) {
  if (count > 0) {
    mix64_kernel<<<grid_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)out, count);
  }
  return (int)cudaGetLastError();
}

extern "C" int combine64_launch(const void* a, const void* b, void* out,
                                long long count, void* stream) {
  if (count > 0) {
    combine64_kernel<<<grid_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)a, (const uint64_t*)b, (uint64_t*)out, count);
  }
  return (int)cudaGetLastError();
}
