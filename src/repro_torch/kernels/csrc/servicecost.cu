// K5: Q candidate center sets x one sampled slab -> Q service-cost
// estimates, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/servicecost.py
// `_servicecost_kernel` (pallas_call in `_service_cost_jit`): for set q and
// slot x, d2 = (|c|^2 + |x|^2) - 2 x.c clamped at 0 over the set's valid
// centers (invalid -> +inf), the min over them, then d^mu = powf(max(d2,
// 1e-38), mu / 2) in cost mode or 1[d2 <= r^2] in ball mode, non-finite ->
// 0, times the HT weight pw * (1 / max(p, 1e-30)) of member slots, summed.
//
// Bound on the H100: operations. At the metric tier's shape (Q = 128,
// Cmax = 20, dim = 68, c = 4098) the distance products are 2 Q Cmax dim c
// = 1.43 GFLOP, 0.021 ms at 67 TFLOP/s fp32, while the bytes (points
// 1.1 MB, centers 0.7 MB) take 0.0005 ms at 3.35 TB/s. So the design is
// about keeping the FMA pipes fed on every SM.
//
// Design: a tile of 4 sets is split over up to 8 blocks, one per slice of
// the slab (launch_plan in servicecost.py: slices from c and dim alone),
// so Q = 128 fills the card in one wave, 32 x 8 blocks of 128 threads, two
// per SM. Warp w scores set w of the tile:
// - the block stages its sets' centers once (row-major, row stride
//   st = 4 x odd >= dim, in chunks of `cpcap` centers per set when a set
//   has more) with their |c|^2 and valid flags, and walks its slice in
//   tiles of 32 * rows points, copied by cp.async into two buffers: tile
//   t + 1 is in flight while tile t is scored;
// - every staged point tile serves all 4 sets; a lane owns `rows` slots
//   of the tile and scores them against 8 centers at a time (the last
//   group of a set 4 when that covers it): per 4 dimensions, one float4
//   load per slot, one broadcast float4 per center and 128 fp32 FMAs
//   (explicit fmaf; --fmad=false rounds everything else as written);
//   float4 rows at a stride of 4 x odd words read without bank conflicts;
// - per slot the running min over the set's valid centers, then the
//   value, times ht, summed over the lane's slots in slice order; a fixed
//   shuffle tree closes the warp, every block stores its partials to
//   scratch, and the block that finishes its tile last adds the slices'
//   partials in rank order (last_block_of_tile).
// The inner loop is bound by shared memory: a 128-bit load takes four
// wavefronts even when broadcast, and a lane issues 12 of them (48
// wavefronts) per 128 FMAs. Alone, the same loop runs at ~40 TFLOP/s on
// the H100 with two warps per scheduler, 60 % of the fp32 peak, against
// ~60 with its operands in registers (tools/kernel_probe.py). The tile's
// blocks are not a thread-block cluster: a cluster of 8 (one block per
// SM) reaches only 120 of the 132 SMs, so Q = 128 would take two waves.
// A slot's dot is its own fmaf chain over the dimensions in order and a
// min is exact, so a slot's value never depends on which sets or how much
// Cmax padding share its block; the order of the sum depends on c and dim
// alone. So a set's answer is bit-identical run to run, alone or in any
// batch, which keeps the argmin of local search reproducible. No atomics,
// no TF32, no library call. powf and the fmaxf floors are the libdevice
// functions the plain version reaches through PyTorch.
#include <cuda_pipeline.h>

#include "common.cuh"

#define SC_SETS 4                  // sets per tile, one warp each
#define SC_THREADS (32 * SC_SETS)
#define SC_MAX_ROWS 4              // slots per lane in a point tile

__device__ __forceinline__ float service_value(float mind2, bool ball,
                                               float r2, float half_mu) {
  if (!isfinite(mind2)) return 0.0f;
  if (ball) return mind2 <= r2 ? 1.0f : 0.0f;
  return mind2 > 0.0f ? powf(fmaxf(mind2, 1e-38f), half_mu) : 0.0f;
}

// Asynchronous copy of rows [0, nrows) of a row-major [., dim] block into
// shared rows of stride st: 16-byte copies when rows are 16-byte aligned,
// else 4-byte ones. Each thread steps its (row, column) without dividing.
__device__ __forceinline__ void stage_rows(float* dst, int st,
                                           const float* src, int nrows,
                                           int dim, bool vec4) {
  const int width = vec4 ? dim >> 2 : dim;
  const int total = nrows * width;
  if (total <= 0) return;
  const int tid = threadIdx.x;
  int row = tid / width, col = tid - (tid / width) * width;
  const int step_rows = SC_THREADS / width;
  const int step_cols = SC_THREADS - step_rows * width;
  for (int e = tid; e < total; e += SC_THREADS) {
    if (vec4)
      __pipeline_memcpy_async(dst + row * st + 4 * col,
                              src + static_cast<size_t>(row) * dim + 4 * col,
                              16);
    else
      __pipeline_memcpy_async(dst + row * st + col,
                              src + static_cast<size_t>(row) * dim + col,
                              sizeof(float));
    row += step_rows;
    col += step_cols;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
}

// |v|^2 of a staged row: four fmaf chains over the dimensions d = 4 i + k
// (k = 0..3) in order, added as (s0 + s1) + (s2 + s3); a fixed order that
// depends on dim alone, and a quarter of one chain's latency.
__device__ __forceinline__ float sq_norm(const float* row, int nd4) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int d4 = 0; d4 < nd4; ++d4) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * d4);
    s0 = fmaf(v.x, v.x, s0);
    s1 = fmaf(v.y, v.y, s1);
    s2 = fmaf(v.z, v.z, s2);
    s3 = fmaf(v.w, v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// One group of G centers against a lane's NR slots: a[r][t] is slot r's
// dot with center t, one fmaf chain over the dimensions in order (the
// zero pad columns add exact zeros), then the running mins.
template <int NR, int G>
__device__ __forceinline__ void group_min(const float* __restrict__ xr,
                                          int st, int nd4,
                                          const float* __restrict__ cg0,
                                          const float* __restrict__ cn2,
                                          const float* __restrict__ cvf,
                                          const float (&pn)[SC_MAX_ROWS],
                                          float (&m)[SC_MAX_ROWS]) {
  float a[NR][G];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int t = 0; t < G; ++t) a[r][t] = 0.0f;
#pragma unroll 2
  for (int d4 = 0; d4 < nd4; ++d4) {
    float4 x[NR], cc[G];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      x[r] = *reinterpret_cast<const float4*>(xr + r * 32 * st + 4 * d4);
#pragma unroll
    for (int t = 0; t < G; ++t)
      cc[t] = *reinterpret_cast<const float4*>(cg0 + t * st + 4 * d4);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int t = 0; t < G; ++t) {
        a[r][t] = fmaf(x[r].x, cc[t].x, a[r][t]);
        a[r][t] = fmaf(x[r].y, cc[t].y, a[r][t]);
        a[r][t] = fmaf(x[r].z, cc[t].z, a[r][t]);
        a[r][t] = fmaf(x[r].w, cc[t].w, a[r][t]);
      }
  }
#pragma unroll
  for (int t = 0; t < G; ++t) {
    const bool ok = cvf[t] != 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float d2 = fmaxf((cn2[t] + pn[r]) - 2.0f * a[r][t], 0.0f);
      m[r] = fminf(m[r], ok ? d2 : INFINITY);
    }
  }
}

template <int G>
__device__ __forceinline__ void group_min_rows(
    int nr, const float* xr, int st, int nd4, const float* cg0,
    const float* cn2, const float* cvf, const float (&pn)[SC_MAX_ROWS],
    float (&m)[SC_MAX_ROWS]) {
  switch (nr) {
    case 4: group_min<4, G>(xr, st, nd4, cg0, cn2, cvf, pn, m); break;
    case 3: group_min<3, G>(xr, st, nd4, cg0, cn2, cvf, pn, m); break;
    case 2: group_min<2, G>(xr, st, nd4, cg0, cn2, cvf, pn, m); break;
    case 1: group_min<1, G>(xr, st, nd4, cg0, cn2, cvf, pn, m); break;
    default: break;
  }
}

__global__ void __launch_bounds__(SC_THREADS, 2) servicecost_kernel(
    const float* __restrict__ pts, const float* __restrict__ probs,
    const uint8_t* __restrict__ member, const float* __restrict__ pw,
    const float* __restrict__ ctr, const uint8_t* __restrict__ cvalid,
    const float* __restrict__ mu, const float* __restrict__ param,
    const int32_t* __restrict__ mode, float* __restrict__ out,
    float* __restrict__ scratch, unsigned int* __restrict__ tickets, int c,
    int dim, int nq, int cmax, int slice_len, int rows, int stages,
    int cpcap) {
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x, nranks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nd4 = (dim + 3) >> 2;
  const int st = 4 * (nd4 | 1);      // row stride: 4 x odd words
  const int ts = 32 * rows;          // slots per point tile
  // 16-byte copies where every row starts 16-byte aligned in memory
  const bool vec4 = (dim & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(pts) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(ctr) & 15) == 0;
  float* xs = smem;                                  // [stages][ts][st]
  float* pns = xs + stages * ts * st;                // [stages][ts] |x|^2
  float* cs = pns + stages * ts;                     // [SETS][cpcap][st]
  float* cn2s = cs + SC_SETS * cpcap * st;           // [SETS][cpcap]
  float* cvs = cn2s + SC_SETS * cpcap;               // [SETS][cpcap]

  const int q0 = blockIdx.y * SC_SETS;
  const long long s0_ll = static_cast<long long>(rank) * slice_len;
  const int s0 = s0_ll < c ? static_cast<int>(s0_ll) : c;
  const int len = (slice_len < c - s0 ? s0 + slice_len : c) - s0;
  const int ntiles = (len + ts - 1) / ts;
  const int nchunks = (cmax + cpcap - 1) / cpcap;

  // pad columns [dim, 4 * nd4) of every staged row are zeros; copies
  // never write them
  if (4 * nd4 > dim) {
    const int padw = 4 * nd4 - dim;
    for (int e = tid; e < (stages * ts + SC_SETS * cpcap) * padw;
         e += SC_THREADS) {
      const int row = e / padw;
      float* base = row < stages * ts ? xs + row * st
                                      : cs + (row - stages * ts) * st;
      base[dim + e - row * padw] = 0.0f;
    }
  }

  auto stage_tile = [&](int t, int buf) {
    const int nt = min(ts, len - t * ts);
    stage_rows(xs + buf * ts * st, st,
               pts + static_cast<size_t>(s0 + t * ts) * dim, nt, dim, vec4);
  };
  auto stage_centers = [&](int k) {
    for (int s = 0; s < SC_SETS; ++s) {
      const int q = q0 + s;
      const int n = q < nq ? min(cpcap, cmax - k * cpcap) : 0;
      stage_rows(cs + s * cpcap * st, st,
                 ctr + (static_cast<size_t>(q) * cmax + k * cpcap) * dim, n,
                 dim, vec4);
    }
  };
  // |c|^2 and the valid flag of every staged center of chunk k; centers
  // past Cmax or past Q are invalid
  auto center_norms = [&](int k) {
    for (int e = tid; e < SC_SETS * cpcap; e += SC_THREADS) {
      const int s = e / cpcap, j = e - s * cpcap;
      const int q = q0 + s, gj = k * cpcap + j;
      const bool ok = q < nq && gj < cmax &&
                      cvalid[static_cast<size_t>(q) * cmax + gj] != 0;
      cn2s[e] = ok ? sq_norm(cs + e * st, nd4) : 0.0f;
      cvs[e] = ok ? 1.0f : 0.0f;
    }
  };

  const int q = q0 + warp;
  const bool live = q < nq;
  const bool ball = live && mode[q] == 1;
  const float rad = live ? param[q] : 0.0f;
  const float r2 = rad * rad;
  const float half_mu = live ? 0.5f * mu[q] : 0.0f;
  const float* csw = cs + warp * cpcap * st;
  const float* cn2w = cn2s + warp * cpcap;
  const float* cvw = cvs + warp * cpcap;

  float part = 0.0f;
  if (ntiles > 0) {
    stage_tile(0, 0);
    if (nchunks == 1) stage_centers(0);
    __pipeline_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int buf = stages == 2 ? (t & 1) : 0;
    const int nt = min(ts, len - t * ts);
    __pipeline_wait_prior(0);
    // every copy of tile t has landed and tile t - 1 is scored
    __syncthreads();
    if (stages == 2 && t + 1 < ntiles) {
      stage_tile(t + 1, buf ^ 1);
      __pipeline_commit();
    }
    if (t == 0 && nchunks == 1) center_norms(0);
    const float* xb = xs + buf * ts * st;
    float* pnb = pns + buf * ts;
    if (tid < nt) pnb[tid] = sq_norm(xb + tid * st, nd4);
    __syncthreads();

    // this lane's slots of the tile: lane + 32 r for r < nr
    // (their HT inputs are loaded now and used after the scoring)
    const int nr = max(0, min(rows, (nt - lane + 31) / 32));
    float pn[SC_MAX_ROWS], m[SC_MAX_ROWS], pr[SC_MAX_ROWS], wt[SC_MAX_ROWS];
    bool mem[SC_MAX_ROWS];
#pragma unroll
    for (int r = 0; r < SC_MAX_ROWS; ++r) {
      pn[r] = 0.0f;
      m[r] = INFINITY;
      pr[r] = 1.0f;
      wt[r] = 0.0f;
      mem[r] = false;
      if (r < nr) {
        const int i = s0 + t * ts + lane + 32 * r;
        pn[r] = pnb[lane + 32 * r];
        pr[r] = probs[i];
        wt[r] = pw != nullptr ? pw[i] : 1.0f;
        mem[r] = member[i] != 0;
      }
    }
    for (int k = 0; k < nchunks; ++k) {
      if (nchunks > 1) {
        __syncthreads();  // the previous chunk is scored
        stage_centers(k);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        center_norms(k);
        __syncthreads();
      }
      if (live) {
        const int nc = min(cpcap, cmax - k * cpcap);
        const float* xr = xb + lane * st;
        for (int g = 0; 8 * g < nc; ++g) {
          const int j0 = 8 * g;
          if (nc - j0 <= 4)
            group_min_rows<4>(nr, xr, st, nd4, csw + j0 * st, cn2w + j0,
                              cvw + j0, pn, m);
          else
            group_min_rows<8>(nr, xr, st, nd4, csw + j0 * st, cn2w + j0,
                              cvw + j0, pn, m);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SC_MAX_ROWS; ++r)
      if (r < nr) {
        const float ht =
            mem[r] ? wt[r] * (1.0f / fmaxf(pr[r], 1e-30f)) : 0.0f;
        part += service_value(m[r], ball, r2, half_mu) * ht;
      }
    if (stages == 1 && t + 1 < ntiles) {
      __syncthreads();  // tile t is scored by every warp
      stage_tile(t + 1, 0);
      __pipeline_commit();
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  // this block's partial of each set -> scratch[tile][rank][set]
  if (lane == 0)
    scratch[(static_cast<size_t>(blockIdx.y) * nranks + rank) * SC_SETS +
            warp] = part;
  if (!last_block_of_tile(tickets + blockIdx.y, nranks)) return;
  if (tid < SC_SETS && q0 + tid < nq) {
    const float* tile =
        scratch + static_cast<size_t>(blockIdx.y) * nranks * SC_SETS;
    float s = 0.0f;
    for (int r = 0; r < nranks; ++r)
      s += __ldcg(tile + r * SC_SETS + tid);
    out[q0 + tid] = s;
  }
}

extern "C" int repro_servicecost(const void* pts, const void* probs,
                                 const void* member, const void* pw,
                                 const void* ctr, const void* cvalid,
                                 const void* mu, const void* param,
                                 const void* mode, void* out, void* scratch,
                                 void* tickets, int c, int dim, int q,
                                 int cmax, int slices, int slice_len,
                                 int rows, int stages, int cpcap, int smem,
                                 void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        servicecost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(slices, (q + SC_SETS - 1) / SC_SETS);
  servicecost_kernel<<<grid, SC_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(probs),
      static_cast<const uint8_t*>(member), static_cast<const float*>(pw),
      static_cast<const float*>(ctr), static_cast<const uint8_t*>(cvalid),
      static_cast<const float*>(mu), static_cast<const float*>(param),
      static_cast<const int32_t*>(mode), static_cast<float*>(out),
      static_cast<float*>(scratch), static_cast<unsigned int*>(tickets), c,
      dim, q, cmax, slice_len, rows, stages, cpcap);
  return static_cast<int>(cudaGetLastError());
}

// registers per thread, local (spill) bytes and static shared bytes
extern "C" int repro_servicecost_attrs(int* regs_local_shared) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, servicecost_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  regs_local_shared[0] = a.numRegs;
  regs_local_shared[1] = static_cast<int>(a.localSizeBytes);
  regs_local_shared[2] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
