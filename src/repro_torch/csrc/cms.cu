// Count-Min Sketch build: out[d, idx[d, n]] += mask[n] over a zeroed
// (depth, width) int32 sketch.
//
// Replaces the TPU kernel cms_update_pallas (src/repro/kernels/cms/
// cms.py:42). The TPU has no fast scatter, so that kernel compares every
// key against an iota of each width tile; that work-around is not copied.
// Here each entry adds into the sketch with a global atomicAdd. At the
// default width (1 << 20) and depth 4 the sketch is 16 MB and stays in
// the H100's 50 MB L2, so the atomics resolve there.
//
// Bound on the H100: 4 bytes an index, 1 a mask byte and 4 a bucket of
// the sketch written once, a few operations an entry: memory-bound. The
// hazard is key skew: every entry of an over-sized block has the same
// key, hence the same bucket in each row, and thousands of equal atomics
// would serialise on one address. So equal buckets are combined within a
// warp first: __match_any_sync gives each lane its peers with the same
// bucket, and only the lowest peer adds their count (__popc). The counts
// are exact integers, so any order of the adds gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

// grid (x, depth): blockIdx.y is the sketch row, x strides over the entries
__global__ void cms_update_kernel(const int32_t* __restrict__ indices,
                                  const uint8_t* __restrict__ mask,
                                  int32_t* __restrict__ sketch, long long n,
                                  long long width) {
  const int32_t* row_idx = indices + (long long)blockIdx.y * n;
  int32_t* row = sketch + (long long)blockIdx.y * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  // the loop bound is warp-uniform (blockDim is a multiple of 32), so every
  // lane of a warp reaches the ballot together
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long e = base + threadIdx.x;
    const bool live = e < n && mask[e] != 0;
    const unsigned active = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int bucket = row_idx[e];
      const unsigned peers = __match_any_sync(active, bucket);
      if (lane == __ffs(peers) - 1) atomicAdd(&row[bucket], __popc(peers));
    }
  }
}

extern "C" int cms_update_launch(const void* indices, const void* mask,
                                 void* sketch, long long n, int depth,
                                 long long width, void* stream) {
  if (n > 0 && depth > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const dim3 grid((unsigned)blocks, (unsigned)depth);
    cms_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)indices, (const uint8_t*)mask, (int32_t*)sketch, n,
        width);
  }
  return (int)cudaGetLastError();
}
