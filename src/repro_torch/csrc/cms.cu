// Count-Min Sketch build: out[d, idx[d, n]] += mask[n] over a zeroed
// (depth, width) int32 sketch.
//
// Replaces the TPU kernel cms_update_pallas (src/repro/kernels/cms/
// cms.py:42). The TPU has no fast scatter, so that kernel compares every
// key against an iota of each width tile; that work-around is not copied.
// Here each live (entry, row) adds into the sketch with a global atomic;
// at the default width (1 << 20) and depth 4 the sketch is 16 MB and
// stays in the H100's 50 MB L2, so the atomics resolve there.
//
// Bound on the H100: bytes (1 a mask byte, 4 an index of a live entry, 4
// a bucket of the sketch written once). The design:
// - one pass over the entries serves every row, so the mask is read once;
// - each lane loads the mask bytes of 16 entries in one 16-byte load, and
//   a warp compacts the live entries of its 512-entry window into a list
//   in shared memory (a warp scan of the lanes' popcounts), so dead
//   entries cost one mask byte and no index load, and the walk over the
//   list keeps every lane busy and the index loads coalesced;
// - the grid is sized to what the SMs hold at once.
// What is left is the atomics: on this card random L2 atomics run at
// about 89e9 a second, 0.51 ms for the 45.6M of the SYN1M launch, six
// times the byte time. Privatising the counts in shared memory (binning
// the keys by slab, then counting each slab) measured slower: it moves
// every key through the scratch and shared atomics twice.
// Skew: every entry of an over-sized block carries the same key, hence
// the same bucket in each row, and thousands of equal atomics would
// serialise on one address. So equal buckets of a warp are combined
// first: __match_any_sync gives each lane its peers with the same bucket,
// and only the lowest peer adds their count (__popc). The counts are
// exact integers, so any order of the adds gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32 * 16;          // entries a warp window

// The mask bytes of entries [e0, e0 + 16) of [0, n), zero past n.
__device__ __forceinline__ uint4 load_mask16(const uint8_t* __restrict__ mask, long long e0,
                                             long long n, bool aligned) {
  if (aligned && e0 + 16 <= n) return *reinterpret_cast<const uint4*>(mask + e0);
  uint64_t lo = 0, hi = 0;
  for (int k = 0; k < 16 && e0 + k < n; ++k) {
    const uint64_t b = mask[e0 + k] != 0;
    if (k < 8) lo |= b << (8 * k); else hi |= b << (8 * (k - 8));
  }
  return make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi, (unsigned)(hi >> 32));
}

// The live entries of a warp's 512-entry window, from each lane's 16 mask
// bytes, compacted into `list` (offsets in the window); the warp's live
// count is returned to every lane.
__device__ __forceinline__ int compact_window(uint4 v, uint16_t* list) {
  const int lane = threadIdx.x & 31;
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      bits |= (unsigned)(((words[q] >> (8 * b)) & 0xFF) != 0) << (4 * q + b);
    }
  }
  const int cnt = __popc(bits);
  int incl = cnt;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += up;
  }
  int at = incl - cnt;
  while (bits) {
    const int k = __ffs(bits) - 1;
    bits &= bits - 1;
    list[at++] = (uint16_t)(16 * lane + k);
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Adds each lane's 1 at row[bucket], one atomic a group of equal buckets
// among the `active` lanes (all on the same row): the lowest peer adds
// the group's count.
__device__ __forceinline__ void aggregated_add(int32_t* row, int bucket, unsigned active) {
  const unsigned peers = __match_any_sync(active, bucket);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(row + bucket, __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const int32_t* __restrict__ indices, const uint8_t* __restrict__ mask,
                  int32_t* __restrict__ sketch, long long n, int depth, long long width) {
  __shared__ uint16_t lists[kWarps * kWindow];
  uint16_t* list = lists + (threadIdx.x / 32) * kWindow;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  const bool aligned = (uintptr_t)mask % 16 == 0;
  for (long long w0 = ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * kWindow;
       w0 < n; w0 += warps * kWindow) {
    const int live = compact_window(load_mask16(mask, w0 + 16 * lane, n, aligned), list);
    // the live entries, 32 at a time; the loop bound is warp-uniform
    for (int r = 0; r < live; r += 32) {
      const unsigned active = __ballot_sync(0xffffffffu, r + lane < live);
      if (r + lane < live) {
        const long long e = w0 + list[r + lane];
        for (int d = 0; d < depth; ++d) {
          aggregated_add(sketch + d * width, indices[d * n + e], active);
        }
      }
      __syncwarp();
    }
  }
}

extern "C" int cms_update_launch(const void* indices, const void* mask, void* sketch,
                                 long long n, int depth, long long width, void* stream) {
  if (n > 0 && depth > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cms_update_kernel, kThreads, 0);
    const long long windows = (n + kWindow - 1) / kWindow;
    long long blocks = (windows + kWarps - 1) / kWarps;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
    cms_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)indices, (const uint8_t*)mask, (int32_t*)sketch, n, depth, width);
  }
  return (int)cudaGetLastError();
}
