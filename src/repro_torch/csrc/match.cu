// Fused pair matching: per candidate pair, the weighted per-column Jaccard
// score, the float32 threshold, and the pair's exclusive rank among the
// matched pairs of its 128-pair tile plus each tile's matched count.
//
// Replaces the TPU kernel match_score_pallas (src/repro/kernels/match/
// match.py:83). The TPU kernel reads pre-gathered (C, T, 128) token stacks;
// here the kernel gathers each pair's two records itself.
//
// The float32 sequence follows score_lanes_jnp (src/repro/kernels/match/
// ops.py:60-75) op for op: f32(inter) / f32(max(union, 1)), total += w*jac
// in weight order, norm += both ? w : 0, score = total / max(norm, 1e-6),
// score >= threshold. Each operation is spelled with its round-to-nearest
// intrinsic and the file is built with --fmad=false, so no FMA contraction
// changes a bit.
//
// Bound on the H100: a pair gathers two records (random b rows: candidates
// are sorted by a) and, compared slot by slot, does T*T equality tests a
// column, about 650 at the synthetic schema. The design:
//
// - pack_kernel, once a call, lays each record out as one row of `stride`
//   int32 words (a multiple of 4: rows are 16-byte aligned). In each column
//   the valid tokens come first, sorted ascending (as int32), then the
//   masked slots; then the 64-bit valid-slot bitmask in two words (the
//   first na slots of each column), then zeros. It replaces the mask bytes,
//   and the sort is paid once a record instead of once a pair.
// - match_kernel: one 128-thread CTA a 128-pair tile, one thread a pair.
//   The tile's 2 x 128 rows are staged into shared memory with 16-byte
//   loads, lanes walking consecutive chunks of one row (coalesced), and
//   stored transposed, word-major with a pitch of 129 pairs, so that the
//   staging stores do not conflict on banks.
// - inter, the count of valid a-slots with an equal valid b-slot, is a
//   merge of the two sorted valid runs: at most na + nb - 1 steps instead
//   of na * nb compares. A repeated a-token is counted once a slot (the b
//   pointer does not move past an equal token); masked slots lie past the
//   runs and are never read. na and nb are popcounts of the mask bits, and
//   a column with na or nb 0 does no steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPitch = kLanes + 1;
constexpr int kPackRows = 128;

// Shared bytes of pack_kernel: the slots' sort keys and the packed rows,
// each at an odd pitch (threads at one slot index hit distinct banks).
int pack_smem_bytes(int t_total, int stride) {
  return kPackRows * ((t_total | 1) * 8 + (stride | 1) * 4);
}

// One thread a record. A slot's sort key is (masked, token as unsigned
// with the sign bit flipped, so that unsigned order is int32 order); a
// masked slot's key ignores its token. Its place in the column is the
// number of slots before it in (key, slot) order.
__global__ void __launch_bounds__(kPackRows)
pack_kernel(const int32_t* __restrict__ tok, const uint8_t* __restrict__ msk,
            int t_total, int stride, const int32_t* __restrict__ col_off,
            int n_cols, long long n_rows, int32_t* __restrict__ rows) {
  extern __shared__ unsigned long long pack_smem[];
  const int kp = t_total | 1;
  const int op = stride | 1;
  unsigned long long* skey = pack_smem;  // [row][kp]
  int32_t* sout = reinterpret_cast<int32_t*>(skey + kPackRows * kp);  // [row][op]
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kPackRows;
  const int nr = (int)min((long long)kPackRows, n_rows - r0);

  // the block's rows are contiguous in tok and msk: coalesced loads
  for (int i = tid; i < nr * t_total; i += kPackRows) {
    const int r = i / t_total;
    skey[r * kp + (i - r * t_total)] =
        msk[r0 * t_total + i]
            ? (unsigned long long)((unsigned)tok[r0 * t_total + i] ^ 0x80000000u)
            : 1ull << 32;
  }
  __syncthreads();

  if (tid < nr) {
    const unsigned long long* key = skey + tid * kp;
    int32_t* o = sout + tid * op;
    unsigned long long mask = 0;
    for (int c = 0; c < n_cols; ++c) {
      const int off = col_off[c];
      const int end = col_off[c + 1];
      int n_valid = 0;
      for (int k = off; k < end; ++k) {
        const unsigned long long kk = key[k];
        int before = 0;
        for (int j = off; j < end; ++j) {
          const unsigned long long kj = key[j];
          before += (kj < kk) | ((kj == kk) & (j < k));
        }
        const bool live = kk >> 32 == 0;
        n_valid += live;
        o[off + before] = live ? (int32_t)((unsigned)kk ^ 0x80000000u) : 0;
      }
      if (n_valid) mask |= (~0ull >> (64 - n_valid)) << off;
    }
    o[t_total] = (int32_t)(unsigned)mask;
    o[t_total + 1] = (int32_t)(unsigned)(mask >> 32);
    for (int k = t_total + 2; k < stride; ++k) o[k] = 0;
  }
  __syncthreads();

  for (int i = tid; i < nr * stride; i += kPackRows) {
    const int r = i / stride;
    rows[r0 * stride + i] = sout[r * op + (i - r * stride)];
  }
}

__device__ __forceinline__ unsigned long long row_mask(const int32_t* s,
                                                       int t_total, int t) {
  return (unsigned long long)(unsigned)s[t_total * kPitch + t] |
         ((unsigned long long)(unsigned)s[(t_total + 1) * kPitch + t] << 32);
}

// Valid a-slots of sorted run a[0, na) with an equal token in b[0, nb);
// both runs at a kPitch word stride.
__device__ __forceinline__ int merge_count(const int32_t* a, int na,
                                           const int32_t* b, int nb) {
  int inter = 0, i = 0, j = 0;
  int32_t x = a[0], y = b[0];
  while (true) {
    inter += x == y;
    if (x <= y) {
      if (++i == na) break;
      x = a[i * kPitch];
    } else {
      if (++j == nb) break;
      y = b[j * kPitch];
    }
  }
  return inter;
}

__global__ void __launch_bounds__(kLanes)
match_kernel(const int32_t* __restrict__ rows, int t_total, int stride,
             const int32_t* __restrict__ col_off,
             const float* __restrict__ weights, int n_cols,
             const int32_t* __restrict__ aa, const int32_t* __restrict__ bb,
             const uint8_t* __restrict__ valid, float threshold,
             int32_t* __restrict__ matched, int32_t* __restrict__ rank,
             int32_t* __restrict__ counts) {
  extern __shared__ int32_t staged[];  // a rows, then b rows: [word][pair]
  __shared__ int row_of[2][kLanes];
  __shared__ int warp_count[kLanes / 32];
  int32_t* sa = staged;
  int32_t* sb = staged + stride * kPitch;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long g = (long long)blockIdx.x * kLanes + tid;
  const bool live = valid[g] != 0;
  row_of[0][tid] = live ? aa[g] : -1;
  row_of[1][tid] = live ? bb[g] : -1;
  __syncthreads();

  const int chunks = stride / 4;
  const int4* rows4 = reinterpret_cast<const int4*>(rows);
#pragma unroll 4
  for (int idx = tid; idx < kLanes * chunks; idx += kLanes) {
    const int r = idx / chunks;
    const int v = idx - r * chunks;
    const int ra = row_of[0][r];
    if (ra < 0) continue;
    const int4 x = rows4[(long long)ra * chunks + v];
    const int4 y = rows4[(long long)row_of[1][r] * chunks + v];
    int32_t* da = sa + 4 * v * kPitch + r;
    int32_t* db = sb + 4 * v * kPitch + r;
    da[0] = x.x; da[kPitch] = x.y; da[2 * kPitch] = x.z; da[3 * kPitch] = x.w;
    db[0] = y.x; db[kPitch] = y.y; db[2 * kPitch] = y.z; db[3 * kPitch] = y.w;
  }
  __syncthreads();

  int m = 0;
  if (live) {
    const unsigned long long ma = row_mask(sa, t_total, tid);
    const unsigned long long mb = row_mask(sb, t_total, tid);
    float total = 0.0f;
    float norm = 0.0f;
    for (int c = 0; c < n_cols; ++c) {
      const int off = col_off[c];
      const int width = col_off[c + 1] - off;
      const unsigned long long keep =
          width >= 64 ? ~0ull : (1ull << width) - 1ull;
      const int na = __popcll((ma >> off) & keep);
      const int nb = __popcll((mb >> off) & keep);
      const bool both = (na > 0) && (nb > 0);
      const int inter = both ? merge_count(sa + off * kPitch + tid, na,
                                           sb + off * kPitch + tid, nb)
                             : 0;
      const int uni = na + nb - inter;
      const float jac =
          both ? __fdiv_rn((float)inter, (float)(uni > 1 ? uni : 1)) : 0.0f;
      const float w = weights[c];
      total = __fadd_rn(total, __fmul_rn(w, jac));
      norm = __fadd_rn(norm, both ? w : 0.0f);
    }
    const float score =
        norm > 0.0f ? __fdiv_rn(total, fmaxf(norm, 1e-6f)) : 0.0f;
    m = score >= threshold;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, m);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_count[w];
  matched[g] = m;
  rank[g] = base + __popc(ballot & ((1u << lane) - 1u));
  if (tid == 0) {
    int tile_total = 0;
    for (int w = 0; w < kLanes / 32; ++w) tile_total += warp_count[w];
    counts[blockIdx.x] = tile_total;
  }
}

}  // namespace

// tok: (n_rows, t_total) int32, msk: (n_rows, t_total) uint8, t_total <= 64;
// rows: (n_rows, stride) int32 scratch, stride = t_total + 2 rounded up to a
// multiple of 4, 16-byte aligned; col_off: n_cols + 1 int32, weights:
// n_cols float32; aa/bb/valid/matched/rank: n_tiles * 128 lanes; counts:
// n_tiles.
extern "C" int match_launch(const void* tok, const void* msk, int t_total,
                            long long n_rows, void* rows, int stride,
                            const void* col_off, const void* weights,
                            int n_cols, const void* aa, const void* bb,
                            const void* valid, float threshold, void* matched,
                            void* rank, void* counts, long long n_tiles,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0) {
    const int smem = pack_smem_bytes(t_total, stride);
    cudaError_t err = cudaFuncSetAttribute(
        pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    pack_kernel<<<(unsigned)((n_rows + kPackRows - 1) / kPackRows), kPackRows,
                  smem, s>>>((const int32_t*)tok, (const uint8_t*)msk, t_total,
                             stride, (const int32_t*)col_off, n_cols, n_rows,
                             (int32_t*)rows);
  }
  if (n_tiles > 0) {
    const int smem = 2 * stride * kPitch * (int)sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    match_kernel<<<(unsigned)n_tiles, kLanes, smem, s>>>(
        (const int32_t*)rows, t_total, stride, (const int32_t*)col_off,
        (const float*)weights, n_cols, (const int32_t*)aa, (const int32_t*)bb,
        (const uint8_t*)valid, threshold, (int32_t*)matched, (int32_t*)rank,
        (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
