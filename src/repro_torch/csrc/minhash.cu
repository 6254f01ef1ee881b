// MinHash over padded token sets: for row r and hash i,
//   out[r, i] = min over valid tokens t of lo32(mix64(t + add[i])),
// with add[i] = (seed + 977 i + 1) * GAMMA mod 2**64, and 0xFFFFFFFF
// where a row has no valid token (and for T == 0).
//
// Replaces the TPU kernel minhash_pallas (src/repro/kernels/minhash/
// minhash.py:65), which kept the (rows, M) running minimum in its output
// block across a sequential token-tile grid axis. Here a thread owns one
// row and kHashesPerThread of its hashes, and walks the row's tokens
// itself: nothing is carried between blocks.
//
// Bound on the H100: integer operations. An evaluation of the 64-bit
// splitmix chain is about 19 32-bit instructions (two wide multiplies of
// three each, three xor-shifts, the add and the minimum), against 8 bytes
// a token and 8 an output. So the design spends instructions on the chain
// alone:
// - the thread computes its addends from the seed and keeps them and its
//   minima in registers, so one token load
//   serves kHashesPerThread independent chains, and the threads of one
//   row read the same addresses in one warp instruction;
// - each masked slot takes the row's first valid token, which leaves the
//   minimum unchanged, so the inner loop has no branch, no packing, no
//   shared memory, no atomic and no barrier;
// - the token widths of the main path (8 and 24) are template parameters:
//   the row's tokens come in 16-byte loads and its mask in 8-byte loads
//   held as a bit word; any other width takes a generic loop, which on
//   the main path's rows ran 15-18% slower on an H100 80GB HBM3 at 700 W.
// The price of the branch-free loop is that masked slots are hashed too:
// R * T * M evaluations, not (valid tokens) * M. Packing the valid tokens
// per warp tile into shared memory measured no faster: the packing, the
// list loads and the folds of minima across lanes cost what it saved.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kHashesPerThread = 8;
constexpr int kThreads = 256;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;
constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix64_lo(uint64_t x) {
  x ^= x >> 30;
  x *= kM1;
  x ^= x >> 27;
  x *= kM2;
  return (uint32_t)(x ^ (x >> 31));
}

__device__ __forceinline__ void hash_token(uint32_t t,
                                           const uint64_t (&add)[kHashesPerThread],
                                           uint32_t (&mn)[kHashesPerThread]) {
#pragma unroll
  for (int i = 0; i < kHashesPerThread; ++i) {
    mn[i] = min(mn[i], mix64_lo((uint64_t)t + add[i]));
  }
}

// kWidth > 0: every row has kWidth tokens (kWidth % 8 == 0, at most 32),
// the tokens 16-byte and the mask 8-byte aligned; kWidth == 0: any width.
template <int kWidth>
__global__ void __launch_bounds__(kThreads)
minhash_kernel(const int64_t* __restrict__ tokens,
               const uint8_t* __restrict__ mask,
               uint64_t seed, int64_t* __restrict__ out,
               long long rows, int width, int num_hashes, int groups) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= rows * groups) return;
  const long long r = item / groups;
  const int h0 = (int)(item - r * groups) * kHashesPerThread;
  const int T = kWidth ? kWidth : width;
  const int64_t* row_tok = tokens + r * T;
  const uint8_t* row_mask = mask + r * T;

  uint32_t bits = 0;  // kWidth > 0: bit j is slot j's mask
  int first = -1;     // the row's first valid slot
  if constexpr (kWidth > 0) {
#pragma unroll
    for (int q = 0; q < kWidth / 8; ++q) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(row_mask) + q);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        bits |= (uint32_t)(((w.x >> (8 * b)) & 0xFF) != 0) << (8 * q + b);
        bits |= (uint32_t)(((w.y >> (8 * b)) & 0xFF) != 0) << (8 * q + 4 + b);
      }
    }
    first = __ffs(bits) - 1;
  } else {
    for (int j = 0; j < T; ++j) {
      if (row_mask[j]) {
        first = j;
        break;
      }
    }
  }

  uint32_t mn[kHashesPerThread];
#pragma unroll
  for (int i = 0; i < kHashesPerThread; ++i) mn[i] = kEmpty;
  if (first >= 0) {
    uint64_t add[kHashesPerThread];
#pragma unroll
    for (int i = 0; i < kHashesPerThread; ++i) {
      // a group past num_hashes repeats the last hash and stores nothing
      add[i] = (seed + 977ull * min(h0 + i, num_hashes - 1) + 1ull) * kGamma;
    }
    const uint32_t fill = (uint32_t)row_tok[first];
    if constexpr (kWidth > 0) {
      const longlong2* pairs = reinterpret_cast<const longlong2*>(row_tok);
#pragma unroll 2
      for (int p = 0; p < kWidth / 2; ++p) {
        const longlong2 v = __ldg(pairs + p);
        hash_token((bits >> (2 * p)) & 1 ? (uint32_t)v.x : fill, add, mn);
        hash_token((bits >> (2 * p + 1)) & 1 ? (uint32_t)v.y : fill, add, mn);
      }
    } else {
      // slots before the first valid one would all hash `fill`
      for (int j = first; j < T; ++j) {
        hash_token(row_mask[j] ? (uint32_t)row_tok[j] : fill, add, mn);
      }
    }
  }
  int64_t* row_out = out + r * num_hashes;
#pragma unroll
  for (int i = 0; i < kHashesPerThread; ++i) {
    if (h0 + i < num_hashes) row_out[h0 + i] = (int64_t)mn[i];
  }
}

template <int kWidth>
static void launch(const void* tokens, const void* mask, uint64_t seed,
                   void* out, long long rows, int width, int num_hashes,
                   int groups, cudaStream_t stream) {
  const long long blocks = (rows * groups + kThreads - 1) / kThreads;
  minhash_kernel<kWidth><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int64_t*)tokens, (const uint8_t*)mask, seed, (int64_t*)out, rows,
      width, num_hashes, groups);
}

extern "C" int minhash_launch(const void* tokens, const void* mask,
                              uint64_t seed, void* out, long long rows,
                              int width, int num_hashes, void* stream) {
  if (num_hashes < 1 || width < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows > 0) {
    const int groups = (num_hashes + kHashesPerThread - 1) / kHashesPerThread;
    const bool aligned = (uintptr_t)tokens % 16 == 0 && (uintptr_t)mask % 8 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (aligned && width == 8) {
      launch<8>(tokens, mask, seed, out, rows, width, num_hashes, groups, s);
    } else if (aligned && width == 24) {
      launch<24>(tokens, mask, seed, out, rows, width, num_hashes, groups, s);
    } else {
      launch<0>(tokens, mask, seed, out, rows, width, num_hashes, groups, s);
    }
  }
  return (int)cudaGetLastError();
}
