// MinHash over padded token sets: for row r and hash i,
//   out[r, i] = min over valid tokens t of lo32(mix64(t + add[i])),
// with add[i] = (seed + 977 i + 1) * GAMMA mod 2**64 from the host, and
// 0xFFFFFFFF where a row has no valid token (and for T == 0).
//
// Replaces the TPU kernel minhash_pallas (src/repro/kernels/minhash/
// minhash.py:65), which kept the (rows, M) running minimum in its output
// block across a sequential token-tile grid axis. Blocks run in no order
// here, so one block owns a tile of rows and loops over its token chunks
// itself.
//
// Bound on the H100: R*T*M evaluations of the 64-bit splitmix chain (two
// wide multiplies each) against R*T*9 bytes read and R*M*8 written. Each
// token is read from device memory once: a chunk of the tile's tokens is
// staged in shared memory, the valid ones packed to the front of their
// row (the minimum does not depend on order), and each thread keeps one
// (row, hash) running minimum, in shared memory across chunks.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 32;
constexpr int kTokenChunk = 64;
constexpr int kSmemBytes = 48 * 1024;
constexpr long long kMaxBlocks = 132 * 8;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;

__device__ __forceinline__ uint32_t mix64_lo(uint64_t x) {
  x ^= x >> 30;
  x *= kM1;
  x ^= x >> 27;
  x *= kM2;
  return (uint32_t)(x ^ (x >> 31));
}

__global__ void __launch_bounds__(kThreads)
minhash_kernel(const int64_t* __restrict__ tokens,
               const uint8_t* __restrict__ mask,
               const uint64_t* __restrict__ adds, int64_t* __restrict__ out,
               long long rows, int width, int num_hashes, int tile_rows) {
  extern __shared__ uint64_t smem[];
  uint64_t* add = smem;                                       // [M]
  uint32_t* acc = (uint32_t*)(add + num_hashes);              // [TR * M]
  uint32_t* tok = acc + tile_rows * num_hashes;               // [TR * TC]
  int* cnt = (int*)(tok + tile_rows * kTokenChunk);           // [TR]
  const int tid = threadIdx.x;
  for (int i = tid; i < num_hashes; i += blockDim.x) add[i] = adds[i];
  const long long n_tiles = (rows + tile_rows - 1) / tile_rows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int tr = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    const int outputs = tr * num_hashes;
    for (int k = tid; k < outputs; k += blockDim.x) acc[k] = 0xFFFFFFFFu;
    for (int t0 = 0; t0 < width; t0 += kTokenChunk) {
      const int tc = width - t0 < kTokenChunk ? width - t0 : kTokenChunk;
      if (tid < tile_rows) cnt[tid] = 0;
      __syncthreads();
      for (int k = tid; k < tr * tc; k += blockDim.x) {
        const int r = k / tc;
        const long long g = (r0 + r) * width + t0 + (k - r * tc);
        if (mask[g]) {
          // zero-extend the uint32 token held in the int64
          tok[r * kTokenChunk + atomicAdd(&cnt[r], 1)] = (uint32_t)tokens[g];
        }
      }
      __syncthreads();
      for (int k = tid; k < outputs; k += blockDim.x) {
        const int r = k / num_hashes;
        const uint64_t a = add[k - r * num_hashes];
        const uint32_t* row = tok + r * kTokenChunk;
        uint32_t m = acc[k];
        for (int j = 0; j < cnt[r]; ++j) {
          const uint32_t h = mix64_lo((uint64_t)row[j] + a);
          m = h < m ? h : m;
        }
        acc[k] = m;
      }
      __syncthreads();
    }
    // each thread writes the minima it alone updated: no barrier needed
    for (int k = tid; k < outputs; k += blockDim.x) {
      out[r0 * num_hashes + k] = (int64_t)acc[k];
    }
  }
}

static int smem_bytes(int num_hashes, int tile_rows) {
  return num_hashes * 8 + tile_rows * (num_hashes * 4 + kTokenChunk * 4 + 4);
}

extern "C" int minhash_launch(const void* tokens, const void* mask,
                              const void* adds, void* out, long long rows,
                              int width, int num_hashes, void* stream) {
  if (rows > 0 && num_hashes > 0) {
    int tile_rows = kMaxTileRows;
    while (tile_rows > 1 && smem_bytes(num_hashes, tile_rows) > kSmemBytes) {
      --tile_rows;
    }
    const int bytes = smem_bytes(num_hashes, tile_rows);
    if (bytes > kSmemBytes) return (int)cudaErrorInvalidValue;
    long long blocks = (rows + tile_rows - 1) / tile_rows;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    minhash_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        (const int64_t*)tokens, (const uint8_t*)mask, (const uint64_t*)adds,
        (int64_t*)out, rows, width, num_hashes, tile_rows);
  }
  return (int)cudaGetLastError();
}
