// K4: B segment predicates x F objectives over one slab, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/segquery.py `_segquery_kernel`
// (pallas_call in `segment_query_slab`): out[j, b] = sum over slots of
// f_j(w) / p (members only) where predicate b selects the slot's key
// (range, bitmask, or a range over hash31(key, salt)).
//
// Bound on the H100: launch latency. The slab is c * 13 bytes (~107 KB at
// c = 8201) and the answer F * B floats; the work is c * B predicate tests
// and c * B * F additions. Design: one 256-thread block per tile of 4
// predicates (all objectives). Each block walks the whole slab from L2 in
// a fixed strided order, keeps its [F, 4] sums in registers, then reduces
// them across threads by warp shuffles and one fixed pass over the 8 warps.
// No atomics and no split of the slab across blocks: the order of every
// addition depends only on c, so an answer is run-to-run deterministic and
// bit-identical whichever other predicates share its batch (the pool's
// coalescing contract). The contraction is plain fp32 adds (no TF32, no
// library GEMM).
#include "common.cuh"

#define TILE_B 4
#define QUERY_THREADS 256
#define PRED_COLS 6

__global__ void __launch_bounds__(QUERY_THREADS)
segquery_kernel(const int32_t* __restrict__ keys, const float* __restrict__ w,
                const float* __restrict__ p,
                const uint8_t* __restrict__ member,
                const int32_t* __restrict__ table, float* __restrict__ out,
                int c, int b, Objectives obj) {
  __shared__ int32_t tab[TILE_B][PRED_COLS];
  __shared__ float red[QUERY_THREADS / 32][REPRO_MAX_OBJECTIVES][TILE_B];
  const int b0 = blockIdx.x * TILE_B;
  if (threadIdx.x < TILE_B * PRED_COLS) {
    const int r = threadIdx.x / PRED_COLS, col = threadIdx.x % PRED_COLS;
    // rows past B never match (lo = 1 > hi = 0)
    tab[r][col] = b0 + r < b ? table[(b0 + r) * PRED_COLS + col]
                             : (col == 0 ? 1 : 0);
  }
  __syncthreads();
  float acc[REPRO_MAX_OBJECTIVES][TILE_B];
#pragma unroll
  for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j)
#pragma unroll
    for (int t = 0; t < TILE_B; ++t) acc[j][t] = 0.0f;

  for (int i = threadIdx.x; i < c; i += QUERY_THREADS) {
    const int32_t k = keys[i];
    const float wi = w[i];
    const float ht = member[i] != 0 ? 1.0f / fmaxf(p[i], 1e-30f) : 0.0f;
    float contrib[REPRO_MAX_OBJECTIVES];
#pragma unroll
    for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j)
      contrib[j] =
          j < obj.nf ? stat_fval(obj.kind[j], obj.param[j], wi) * ht : 0.0f;
#pragma unroll
    for (int t = 0; t < TILE_B; ++t) {
      int32_t v = k;
      if (tab[t][5] & 1)
        v = static_cast<int32_t>(
            hash_u32(static_cast<uint32_t>(k),
                     static_cast<uint32_t>(tab[t][4])) >> 1);
      const bool sel = v >= tab[t][0] && v <= tab[t][1] &&
                       (v & tab[t][2]) == tab[t][3] && k >= 0;
      if (sel) {
#pragma unroll
        for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j) acc[j][t] += contrib[j];
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j)
#pragma unroll
    for (int t = 0; t < TILE_B; ++t) {
      float v = acc[j][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][j][t] = v;
    }
  __syncthreads();
  if (threadIdx.x < REPRO_MAX_OBJECTIVES * TILE_B) {
    const int j = threadIdx.x / TILE_B, t = threadIdx.x % TILE_B;
    float s = 0.0f;
    for (int wv = 0; wv < QUERY_THREADS / 32; ++wv) s += red[wv][j][t];
    if (j < obj.nf && b0 + t < b) out[j * b + b0 + t] = s;
  }
}

extern "C" int repro_segquery(const void* keys, const void* w, const void* p,
                              const void* member, const void* table,
                              void* out, int c, int b, int nf,
                              const void* kinds, const void* params,
                              void* stream) {
  const Objectives obj = make_objectives(
      nf, static_cast<const int*>(kinds), static_cast<const float*>(params));
  const int blocks = (b + TILE_B - 1) / TILE_B;
  segquery_kernel<<<blocks, QUERY_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(w),
      static_cast<const float*>(p), static_cast<const uint8_t*>(member),
      static_cast<const int32_t*>(table), static_cast<float*>(out), c, b,
      obj);
  return static_cast<int>(cudaGetLastError());
}
