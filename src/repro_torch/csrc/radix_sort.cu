// LSB radix sort of u64 sort words (int64 bit patterns), keys only, 8-bit
// digits: one histogram kernel for every digit position, then one
// onesweep kernel a pass.
//
// Replaces the TPU kernel radix_pass_pallas (src/repro/kernels/sort/
// sort.py:71), which gave a 4-bit digit's in-tile rank and tile histogram
// and left the digit-major base scan and the scatter to XLA. Here the
// pass does all of it: rank, tile prefix, global base and scatter.
//
// Bound on the H100: a pass reads and writes each word once (16 bytes a
// word), the histogram reads each word once more, so the sort is memory-
// bound at n * (8 + 16 * passes) bytes. What the design does about it:
//
// - counts_kernel reads the words once and counts every digit position in
//   shared-memory 256-bin counters (a warp whose 32 digits agree adds 32
//   with one atomic: the high digits of the packed pair words repeat
//   across a warp), then adds them to the global (n_digits, 256) counts.
// - pass_kernel is the onesweep pass. Each CTA takes the next tile index
//   from an atomic counter (so every earlier tile is already running and
//   decoupled look-back always makes progress), loads its 4096 words with
//   16-byte loads into shared memory, and ranks each word stably among the
//   tile's same-digit words: each warp walks its 512 words in order, and
//   __match_any_sync/__popc against per-warp 256-bin counters give the
//   in-warp rank; a scan over the 8 warps gives the tile offsets. Atomics
//   only count; they never decide an order. The tile publishes its 256
//   digit counts, finds its prefix over earlier tiles by decoupled
//   look-back, and writes its words through shared memory in digit order,
//   so each digit's words leave as one run of consecutive addresses.
//
// Status words of the look-back: 64 bits, 2 flag bits (aggregate /
// inclusive prefix) over a 62-bit count, written and read whole, so a
// published count and its flag are never seen apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // one thread a digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // words a thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarpWords = 32 * kItems;
constexpr int kMaxDigits = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagInc = 2ull << 62;
constexpr unsigned long long kValueMask = kFlagAgg - 1;

__device__ __forceinline__ unsigned digit(unsigned long long w, int shift,
                                          unsigned mask) {
  return (unsigned)(w >> shift) & mask;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Exclusive scan of one value a thread over the block (thread order).
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  unsigned base = 0;
  for (int k = 0; k < warp; ++k) base += warp_sum[k];
  __syncthreads();  // warp_sum may be reused right after
  return base + x - v;
}

__global__ void __launch_bounds__(kThreads)
counts_kernel(const unsigned long long* __restrict__ words, long long n,
              int n_digits, unsigned last_mask, unsigned* __restrict__ counts) {
  __shared__ unsigned sh[kMaxDigits * kRadix];
  for (int i = threadIdx.x; i < kMaxDigits * kRadix; i += kThreads) sh[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  // the loop bound is the same for the whole block, so every warp vote
  // below has all 32 lanes
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool live = i < n;
    const unsigned long long w = live ? words[i] : 0ull;
    const bool full_warp = __ballot_sync(kFull, live) == kFull;
    for (int q = 0; q < n_digits; ++q) {
      const unsigned d = digit(w, 8 * q, q == n_digits - 1 ? last_mask : 0xffu);
      const unsigned d0 = __shfl_sync(kFull, d, 0);
      if (full_warp && __all_sync(kFull, d == d0)) {
        if (lane == 0) atomicAdd(&sh[q * kRadix + d0], 32u);
      } else if (live) {
        atomicAdd(&sh[q * kRadix + d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_digits * kRadix; i += kThreads) {
    if (sh[i]) atomicAdd(&counts[i], sh[i]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
pass_kernel(const unsigned long long* __restrict__ in,
            unsigned long long* __restrict__ out, long long n, int shift,
            unsigned mask, const unsigned* __restrict__ totals,
            unsigned long long* __restrict__ status,
            unsigned long long* __restrict__ next_tile) {
  __shared__ __align__(16) unsigned long long keys[kTile];
  __shared__ unsigned warp_cnt[kWarps][kRadix];
  __shared__ unsigned tile_start[kRadix];
  __shared__ long long out_base[kRadix];
  __shared__ unsigned warp_sum[kWarps];
  __shared__ unsigned tile_sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) tile_sh = (unsigned)atomicAdd(next_tile, 1ull);
  for (int i = tid; i < kWarps * kRadix; i += kThreads) (&warp_cnt[0][0])[i] = 0;
  __syncthreads();
  const unsigned tile = tile_sh;
  const long long first = (long long)tile * kTile;
  const int valid = (int)min((long long)kTile, n - first);

  // 1. load the tile: 16-byte loads (the input is 16-byte aligned)
  if (valid == kTile) {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + first);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(keys);
#pragma unroll
    for (int k = 0; k < kTile / 2 / kThreads; ++k)
      dst[tid + k * kThreads] = src[tid + k * kThreads];
  } else {
    for (int k = tid; k < valid; k += kThreads) keys[k] = in[first + k];
  }
  __syncthreads();

  // 2. stable in-warp rank: word (i, lane) of warp w is tile word
  // w * 512 + i * 32 + lane, walked in that order
  unsigned long long w[kItems];
  unsigned dr[kItems];  // digit (9 bits; kRadix past the end) | rank << 9
  const unsigned below = (1u << lane) - 1u;
  unsigned* wc = warp_cnt[warp];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = warp * kWarpWords + i * 32 + lane;
    w[i] = keys[idx];
    const unsigned d = idx < valid ? digit(w[i], shift, mask) : kRadix;
    const unsigned peers = __match_any_sync(kFull, d);
    const int leader = __ffs(peers) - 1;
    unsigned before = 0;
    if (lane == leader && d < kRadix) {
      before = wc[d];
      wc[d] = before + __popc(peers);
    }
    before = __shfl_sync(kFull, before, leader);
    dr[i] = d | ((before + __popc(peers & below)) << 9);
    __syncwarp();
  }
  __syncthreads();

  // 3. thread tid owns digit tid: warp offsets, tile count, publish
  unsigned count = 0;
  for (int k = 0; k < kWarps; ++k) {
    const unsigned c = warp_cnt[k][tid];
    warp_cnt[k][tid] = count;
    count += c;
  }
  unsigned long long* my_status = status + (long long)tile * kRadix + tid;
  st_relaxed(my_status, (tile == 0 ? kFlagInc : kFlagAgg) | count);
  const unsigned start = block_exclusive_scan(count, warp_sum);
  const unsigned global = block_exclusive_scan(totals[tid], warp_sum);
  tile_start[tid] = start;
  __syncthreads();

  // 4. scatter into shared memory in digit order (overlaps the look-back
  // of the CTAs before this one)
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = dr[i] & 0x1ffu;
    if (d < kRadix) keys[tile_start[d] + warp_cnt[warp][d] + (dr[i] >> 9)] = w[i];
  }

  // 5. decoupled look-back over the earlier tiles, digit tid
  unsigned long long prefix = 0;
  if (tile > 0) {
    long long j = (long long)tile - 1;
    while (true) {
      const unsigned long long s = ld_relaxed(status + j * kRadix + tid);
      if ((s & ~kValueMask) == 0) continue;  // tile j has not published
      prefix += s & kValueMask;
      if (s & kFlagInc) break;
      --j;
    }
    st_relaxed(my_status, kFlagInc | (prefix + count));
  }
  out_base[tid] = (long long)global + (long long)prefix - start;
  __syncthreads();

  // 6. write out: consecutive tile words of one digit go to consecutive
  // addresses
  for (int k = tid; k < valid; k += kThreads) {
    const unsigned long long v = keys[k];
    out[out_base[digit(v, shift, mask)] + k] = v;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

// counts: (n_digits, 256) uint32, zeroed here; digit q covers bits
// [8q, 8q + 8), the last one masked to last_bits.
extern "C" int radix_counts_launch(const void* words, long long n, int n_digits,
                                   int last_bits, void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0,
                                    (size_t)n_digits * kRadix * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const long long cap = 8LL * sm_count();
    counts_kernel<<<(unsigned)(want < cap ? want : cap), kThreads, 0, s>>>(
        (const unsigned long long*)words, n, n_digits, (1u << last_bits) - 1u,
        (unsigned*)counts);
  }
  return (int)cudaGetLastError();
}

// One pass: out = in stably partitioned by digit (in >> shift) & mask;
// totals: the 256 counts of that digit over in; status: status_len uint64
// of scratch, at least radix_pass_status_len(n), zeroed here (look-back
// states, then the tile counter).
extern "C" long long radix_pass_status_len(long long n) {
  return (n + kTile - 1) / kTile * kRadix + 1;
}

extern "C" int radix_pass_launch(const void* in, void* out, long long n,
                                 int shift, int bits, const void* totals,
                                 void* status, long long status_len,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (status_len < radix_pass_status_len(n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      status, 0, (size_t)radix_pass_status_len(n) * sizeof(unsigned long long),
      s);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    unsigned long long* st = (unsigned long long*)status;
    pass_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        (const unsigned long long*)in, (unsigned long long*)out, n, shift,
        (1u << bits) - 1u, (const unsigned*)totals, st, st + n_tiles * kRadix);
  }
  return (int)cudaGetLastError();
}
