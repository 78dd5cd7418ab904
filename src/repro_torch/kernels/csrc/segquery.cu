// K4: B segment predicates x F objectives over one slab, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/segquery.py `_segquery_kernel`
// (pallas_call in `segment_query_slab`): out[j, b] = sum over slots of
// f_j(w) / p (members only) where predicate b selects the slot's key
// (range, bitmask, or a range over hash31(key, salt)).
//
// Bound on the H100: latency, not bytes or operations. The slab is
// c * 13 bytes (~107 KB at c = 8201) and the work c * B predicate tests
// plus c * B * F adds (34 MFLOP at B = 256, ~0.5 us at the fp32 rate); a
// launch, one pass over the slab from L2 and one reduction cost more.
//
// Design: a tile of 16 predicates (one warp each) is split over up to 16
// blocks, one per slice of the slab. The slice count comes from c alone
// (launch_plan in segquery.py: slices of ~512 slots), so the whole card
// works at B = 256 (16 x 16 blocks, two per SM) and a slot's contributions
// f_j(w) * ht are computed once per block: staged with the keys in shared
// memory (up to 1152 slots per pass, all of a thread's loads issued
// before any is used), not recomputed per predicate. Each warp's lanes
// stride over the staged slots in a fixed order (4 slots' tests, their
// independent hashes, before their adds), keep acc[F] in registers and close
// with a fixed shuffle tree. Every block stores its [16, F] partials to
// scratch; the block that finishes its tile last adds the slices'
// partials in rank order and writes out[j, b] (last_block_of_tile). The
// order of every addition depends on c alone, never on B, on which
// predicates share a tile or on which block finishes last: an answer is
// run-to-run deterministic and bit-identical alone or in any batch (the
// pool's coalescing contract). Plain fp32 adds, no atomics on the sums, no
// TF32, no library call. The tile's blocks are not a thread-block
// cluster summed through distributed shared memory: a cluster of 8 (one
// block per SM) reaches only 120 of the H100's 132 SMs, and it would cap
// the split at 8 (tools/kernel_probe.py).
#include "common.cuh"

#define Q_WARPS 16                 // predicates per tile, one warp each
#define Q_THREADS (32 * Q_WARPS)
#define Q_CHUNK 1152               // slots staged per pass over a slice
#define Q_PER ((Q_CHUNK + Q_THREADS - 1) / Q_THREADS)
#define Q_BATCH 4                  // slots a lane tests before it adds
#define PRED_COLS 6
#define Q_PARTS (Q_WARPS * REPRO_MAX_OBJECTIVES)

__global__ void __launch_bounds__(Q_THREADS)
segquery_kernel(const int32_t* __restrict__ keys, const float* __restrict__ w,
                const float* __restrict__ p,
                const uint8_t* __restrict__ member,
                const int32_t* __restrict__ table, float* __restrict__ out,
                float* __restrict__ scratch,
                unsigned int* __restrict__ tickets, int c, int b,
                int slice_len, Objectives obj) {
  __shared__ int32_t ks[Q_CHUNK];
  __shared__ float cs[REPRO_MAX_OBJECTIVES][Q_CHUNK];
  const int rank = blockIdx.x, nranks = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pb = blockIdx.y * Q_WARPS + warp;  // this warp's predicate
  // rows past B never match (lo = 1 > hi = 0)
  int32_t lo = 1, hi = 0, mask = 0, want = 0, salt = 0, flags = 0;
  if (pb < b) {
    const int32_t* t = table + static_cast<size_t>(pb) * PRED_COLS;
    lo = t[0];
    hi = t[1];
    mask = t[2];
    want = t[3];
    salt = t[4];
    flags = t[5];
  }
  const long long s0_ll = static_cast<long long>(rank) * slice_len;
  const int s0 = s0_ll < c ? static_cast<int>(s0_ll) : c;
  const int s1 = slice_len < c - s0 ? s0 + slice_len : c;

  float acc[REPRO_MAX_OBJECTIVES];
#pragma unroll
  for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j) acc[j] = 0.0f;

  for (int base = s0; base < s1; base += Q_CHUNK) {
    const int n = min(Q_CHUNK, s1 - base);
    __syncthreads();  // the previous pass's slots are consumed
    int32_t kv[Q_PER];
    float wv[Q_PER], pv[Q_PER];
    bool mv[Q_PER];
#pragma unroll
    for (int u = 0; u < Q_PER; ++u) {
      const int i = threadIdx.x + u * Q_THREADS;
      if (i < n) {
        kv[u] = keys[base + i];
        wv[u] = w[base + i];
        pv[u] = p[base + i];
        mv[u] = member[base + i] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < Q_PER; ++u) {
      const int i = threadIdx.x + u * Q_THREADS;
      if (i < n) {
        const float ht = mv[u] ? 1.0f / fmaxf(pv[u], 1e-30f) : 0.0f;
        ks[i] = kv[u];
#pragma unroll
        for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j)
          if (j < obj.nf)
            cs[j][i] = stat_fval(obj.kind[j], obj.param[j], wv[u]) * ht;
      }
    }
    __syncthreads();
    if (pb < b) {
      // the lane's slots lane, lane + 32, ... in order, Q_BATCH at a time:
      // all the batch's tests (independent hashes) first, then its adds
      for (int i0 = lane; i0 < n; i0 += 32 * Q_BATCH) {
        bool sel[Q_BATCH];
#pragma unroll
        for (int u = 0; u < Q_BATCH; ++u) {
          const int i = i0 + 32 * u;
          const int32_t k = i < n ? ks[i] : -1;
          int32_t v = k;
          if (flags & 1)
            v = static_cast<int32_t>(hash_u32(static_cast<uint32_t>(k),
                                              static_cast<uint32_t>(salt))
                                     >> 1);
          sel[u] = v >= lo && v <= hi && (v & mask) == want && k >= 0;
        }
#pragma unroll
        for (int u = 0; u < Q_BATCH; ++u)
          if (sel[u]) {
#pragma unroll
            for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j)
              if (j < obj.nf) acc[j] += cs[j][i0 + 32 * u];
          }
      }
    }
  }
  // this block's [16, F] partials -> scratch[tile][rank]
  float* part = scratch + (static_cast<size_t>(blockIdx.y) * nranks + rank)
                              * Q_PARTS;
#pragma unroll
  for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp * REPRO_MAX_OBJECTIVES + j] = v;
  }
  if (!last_block_of_tile(tickets + blockIdx.y, nranks)) return;
  if (threadIdx.x < Q_PARTS) {
    const int wv = threadIdx.x / REPRO_MAX_OBJECTIVES;
    const int j = threadIdx.x % REPRO_MAX_OBJECTIVES;
    const int q = blockIdx.y * Q_WARPS + wv;
    if (q < b && j < obj.nf) {
      const float* tile = scratch + static_cast<size_t>(blockIdx.y) * nranks
                                        * Q_PARTS;
      float s = 0.0f;
      for (int r = 0; r < nranks; ++r)
        s += __ldcg(tile + r * Q_PARTS + threadIdx.x);
      out[static_cast<size_t>(j) * b + q] = s;
    }
  }
}

extern "C" int repro_segquery(const void* keys, const void* w, const void* p,
                              const void* member, const void* table,
                              void* out, void* scratch, void* tickets, int c,
                              int b, int slices, int slice_len, int nf,
                              const void* kinds, const void* params,
                              void* stream) {
  const Objectives obj = make_objectives(
      nf, static_cast<const int*>(kinds), static_cast<const float*>(params));
  const dim3 grid(slices, (b + Q_WARPS - 1) / Q_WARPS);
  segquery_kernel<<<grid, Q_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(w),
      static_cast<const float*>(p), static_cast<const uint8_t*>(member),
      static_cast<const int32_t*>(table), static_cast<float*>(out),
      static_cast<float*>(scratch), static_cast<unsigned int*>(tickets), c, b,
      slice_len, obj);
  return static_cast<int>(cudaGetLastError());
}

// registers per thread, local (spill) bytes and static shared bytes
extern "C" int repro_segquery_attrs(int* regs_local_shared) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, segquery_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  regs_local_shared[0] = a.numRegs;
  regs_local_shared[1] = static_cast<int>(a.localSizeBytes);
  regs_local_shared[2] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
