// One LSB radix-sort digit pass over u64 sort words (int64 bit patterns):
// for 4-bit digit p, each element's stable rank among same-digit elements
// earlier in its 1024-element tile, and each tile's 16-bin histogram.
//
// Replaces the TPU kernel radix_pass_pallas (src/repro/kernels/sort/
// sort.py:71); the tile is the TPU's (8, 128) tile flattened row-major, so
// rank and histogram equal the TPU kernel's. The digit-major base scan and
// the scatter stay in PyTorch, as they stayed in XLA.
//
// Bound on the H100: 12 bytes an element (8 in, 4 out), a few operations,
// so memory-bound. One thread per element, one 1024-thread block per tile.
// The rank must be stable, so it does not come from shared-memory atomics
// (whose order is arbitrary): __match_any_sync gives each lane the lanes of
// its warp with the same digit, __popc of those below it is the in-warp
// rank, and a 16-digit exclusive scan over the block's 32 warps adds the
// counts of earlier warps.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTile = 1024;
constexpr int kRadix = 16;
constexpr int kWarps = kTile / 32;

__global__ void __launch_bounds__(kTile)
radix_pass_kernel(const int64_t* __restrict__ words, int32_t* __restrict__ rank,
                  int32_t* __restrict__ hist, int shift) {
  __shared__ int warp_count[kWarps][kRadix];
  __shared__ int warp_base[kWarps][kRadix];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long g = (long long)blockIdx.x * kTile + tid;
  // logical digit extraction: -1 (the sentinel) gives digit 0xF everywhere
  const unsigned d =
      (unsigned)(((unsigned long long)words[g] >> shift) & (kRadix - 1));
  if (tid < kWarps * kRadix) (&warp_count[0][0])[tid] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (lane == __ffs(peers) - 1) warp_count[warp][d] = __popc(peers);
  __syncthreads();
  if (tid < kRadix) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      warp_base[w][tid] = acc;
      acc += warp_count[w][tid];
    }
    hist[(long long)blockIdx.x * kRadix + tid] = acc;
  }
  __syncthreads();
  rank[g] = warp_base[warp][d] + in_warp;
}

// words: n_tiles * 1024 int64; rank: same count int32; hist: n_tiles * 16.
extern "C" int radix_pass_launch(const void* words, void* rank, void* hist,
                                 long long n_tiles, int shift, void* stream) {
  if (n_tiles > 0) {
    radix_pass_kernel<<<(unsigned)n_tiles, kTile, 0, (cudaStream_t)stream>>>(
        (const int64_t*)words, (int32_t*)rank, (int32_t*)hist, shift);
  }
  return (int)cudaGetLastError();
}
