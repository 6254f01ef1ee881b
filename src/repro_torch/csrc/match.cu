// Fused pair matching: per candidate pair, the weighted per-column Jaccard
// score, the float32 threshold, and the pair's exclusive rank among the
// matched pairs of its 128-pair tile plus each tile's matched count.
//
// Replaces the TPU kernel match_score_pallas (src/repro/kernels/match/
// match.py:83). The TPU kernel reads pre-gathered (C, T, 128) token stacks;
// here each thread gathers its own pair's rows from the concatenated
// (N, T_total) token/mask matrices, which lie in device memory once.
//
// The float32 sequence follows score_lanes_jnp (src/repro/kernels/match/
// ops.py:60-75) op for op: f32(inter) / f32(max(union, 1)), total += w*jac
// in weight order, norm += both ? w : 0, score = total / max(norm, 1e-6),
// score >= threshold. Each operation is spelled with its round-to-nearest
// intrinsic and the file is built with --fmad=false, so no FMA contraction
// changes a bit.
//
// Bound on the H100: each pair reads two token rows (5 bytes a token slot)
// and does T*T equality tests per column; at the synthetic schema that is
// about 360 bytes against about 650 compares a pair, so it is memory-bound
// when the rows come from device memory. One thread per pair, 128-thread
// blocks = one tile; the in-tile rank comes from warp ballots and __popc.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLanes = 128;

__global__ void __launch_bounds__(kLanes)
match_kernel(const int32_t* __restrict__ tok, const uint8_t* __restrict__ msk,
             int t_total, const int32_t* __restrict__ col_off,
             const float* __restrict__ weights, int n_cols,
             const int32_t* __restrict__ aa, const int32_t* __restrict__ bb,
             const uint8_t* __restrict__ valid, float threshold,
             int32_t* __restrict__ matched, int32_t* __restrict__ rank,
             int32_t* __restrict__ counts) {
  __shared__ int warp_count[kLanes / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long g = (long long)blockIdx.x * kLanes + tid;
  int m = 0;
  if (valid[g]) {
    const long long ra = (long long)aa[g] * t_total;
    const long long rb = (long long)bb[g] * t_total;
    float total = 0.0f;
    float norm = 0.0f;
    for (int c = 0; c < n_cols; ++c) {
      const int off = col_off[c];
      const int width = col_off[c + 1] - off;
      int inter = 0, na = 0, nb = 0;
      for (int j = 0; j < width; ++j) nb += msk[rb + off + j] != 0;
      for (int i = 0; i < width; ++i) {
        if (!msk[ra + off + i]) continue;
        ++na;
        const int32_t x = tok[ra + off + i];
        int hit = 0;
        for (int j = 0; j < width; ++j)
          hit |= (msk[rb + off + j] != 0) & (tok[rb + off + j] == x);
        inter += hit;
      }
      const bool both = (na > 0) && (nb > 0);
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

// aa/bb/valid/matched/rank: n_tiles * 128 lanes; counts: n_tiles.
extern "C" int match_launch(const void* tok, const void* msk, int t_total,
                            const void* col_off, const void* weights,
                            int n_cols, const void* aa, const void* bb,
                            const void* valid, float threshold, void* matched,
                            void* rank, void* counts, long long n_tiles,
                            void* stream) {
  if (n_tiles > 0) {
    match_kernel<<<(unsigned)n_tiles, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tok, (const uint8_t*)msk, t_total,
        (const int32_t*)col_off, (const float*)weights, n_cols,
        (const int32_t*)aa, (const int32_t*)bb, (const uint8_t*)valid,
        threshold, (int32_t*)matched, (int32_t*)rank, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
