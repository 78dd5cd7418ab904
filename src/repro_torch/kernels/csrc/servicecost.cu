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
// 1.1 MB, centers 0.7 MB) take 0.0005 ms at 3.35 TB/s.
//
// Design, simple and deterministic: one block per set. The block stages its
// set's centers in shared memory, transposed [dim][Cmax rounded up to 8],
// with their |c|^2 and valid flags, then walks the whole slab in a fixed
// order in tiles of 2 * blockDim slots, each tile copied into shared
// memory by asynchronous copies (cp.async, all in flight at once; odd row
// stride: conflict-free reads). A thread owns two slots of a tile and
// scores them against 8 centers at a time: per dimension two
// point loads, two broadcast float4 center loads and 16 fp32 FMAs
// (explicit fmaf; everything else is rounded as written, --fmad=false).
// Its partial sum runs over its slots in slab order; a warp-shuffle tree
// and one fixed pass over the warps reduce the block. No atomics and no
// split of the slab across blocks, and the thread count depends on dim
// alone: a set's answer is bit-identical run to run and whichever other
// sets (and whatever Cmax padding) share its batch, which keeps the argmin
// of local search reproducible. The ragged dim and the ragged last tile
// are masked here, never padded by the wrapper. powf and the fmaxf floors
// are the libdevice functions the plain version reaches through PyTorch.
//
// Later work: the tensor cores. TF32 would break parity with the fp32
// plain version, so it takes a 3xTF32 split or an fp32 FMA tiling that
// reuses each staged point across more centers.
#include <cuda_pipeline.h>

#include "common.cuh"

#define SC_GROUP 8  // centers scored per pass over the dimensions

__device__ __forceinline__ float service_value(float mind2, bool ball,
                                               float r2, float half_mu) {
  if (!isfinite(mind2)) return 0.0f;
  if (ball) return mind2 <= r2 ? 1.0f : 0.0f;
  return mind2 > 0.0f ? powf(fmaxf(mind2, 1e-38f), half_mu) : 0.0f;
}

__global__ void servicecost_kernel(
    const float* __restrict__ pts, const float* __restrict__ probs,
    const uint8_t* __restrict__ member, const float* __restrict__ pw,
    const float* __restrict__ ctr, const uint8_t* __restrict__ cvalid,
    const float* __restrict__ mu, const float* __restrict__ param,
    const int32_t* __restrict__ mode, float* __restrict__ out, int c,
    int dim, int cmax) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int cp = (cmax + SC_GROUP - 1) / SC_GROUP * SC_GROUP;
  const int xst = dim | 1;       // odd stride: conflict-free row reads
  const int ts = 2 * nthr;       // slots per tile
  float* cs = smem;              // [dim][cp] centers, transposed
  float* cn2 = cs + dim * cp;    // [cp] |c|^2
  float* cvf = cn2 + cp;         // [cp] 1 valid, 0 not
  float* xs = cvf + cp;          // [ts][xst] the tile's points
  float* red = xs + ts * xst;    // [32] per-warp sums

  const float* cq = ctr + static_cast<size_t>(q) * cmax * dim;
  for (int e = tid; e < dim * cp; e += nthr) {
    const int d = e / cp, j = e - d * cp;
    cs[e] = j < cmax ? cq[static_cast<size_t>(j) * dim + d] : 0.0f;
  }
  for (int j = tid; j < cp; j += nthr) {
    float s = 0.0f;
    const bool ok = j < cmax && cvalid[static_cast<size_t>(q) * cmax + j];
    if (j < cmax)
      for (int d = 0; d < dim; ++d) {
        const float v = cq[static_cast<size_t>(j) * dim + d];
        s = fmaf(v, v, s);
      }
    cn2[j] = s;
    cvf[j] = ok ? 1.0f : 0.0f;
  }
  const bool ball = mode[q] == 1;
  const float r = param[q];
  const float r2 = r * r;
  const float half_mu = 0.5f * mu[q];
  const int step_rows = nthr / dim, step_cols = nthr - step_rows * dim;

  float part = 0.0f;
  for (int base = 0; base < c; base += ts) {
    const int nt = min(ts, c - base);
    __syncthreads();  // the previous tile is consumed (and centers staged)
    // the tile is nt * dim contiguous floats: every thread issues all its
    // asynchronous copies before waiting on any, and steps its (row,
    // column) position without a division
    const float* src = pts + static_cast<size_t>(base) * dim;
    int row = tid / dim, col = tid - (tid / dim) * dim;
    for (int e = tid; e < nt * dim; e += nthr) {
      __pipeline_memcpy_async(xs + row * xst + col, src + e, sizeof(float));
      row += step_rows;
      col += step_cols;
      if (col >= dim) {
        col -= dim;
        ++row;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const float* x0 = xs + tid * xst;
    const float* x1 = xs + (tid + nthr) * xst;
    float p0 = 0.0f, p1 = 0.0f;
    if (tid < nt)
      for (int d = 0; d < dim; ++d) p0 = fmaf(x0[d], x0[d], p0);
    if (tid + nthr < nt)
      for (int d = 0; d < dim; ++d) p1 = fmaf(x1[d], x1[d], p1);
    float m0 = INFINITY, m1 = INFINITY;
    for (int g = 0; g < cp; g += SC_GROUP) {
      float a0[SC_GROUP], a1[SC_GROUP];
#pragma unroll
      for (int t = 0; t < SC_GROUP; ++t) a0[t] = a1[t] = 0.0f;
      // rows past nt hold stale shared memory; their sums are never used
#pragma unroll 4
      for (int d = 0; d < dim; ++d) {
        const float xa = x0[d], xb = x1[d];
        const float4 ca = *reinterpret_cast<const float4*>(cs + d * cp + g);
        const float4 cb =
            *reinterpret_cast<const float4*>(cs + d * cp + g + 4);
        a0[0] = fmaf(xa, ca.x, a0[0]);
        a0[1] = fmaf(xa, ca.y, a0[1]);
        a0[2] = fmaf(xa, ca.z, a0[2]);
        a0[3] = fmaf(xa, ca.w, a0[3]);
        a0[4] = fmaf(xa, cb.x, a0[4]);
        a0[5] = fmaf(xa, cb.y, a0[5]);
        a0[6] = fmaf(xa, cb.z, a0[6]);
        a0[7] = fmaf(xa, cb.w, a0[7]);
        a1[0] = fmaf(xb, ca.x, a1[0]);
        a1[1] = fmaf(xb, ca.y, a1[1]);
        a1[2] = fmaf(xb, ca.z, a1[2]);
        a1[3] = fmaf(xb, ca.w, a1[3]);
        a1[4] = fmaf(xb, cb.x, a1[4]);
        a1[5] = fmaf(xb, cb.y, a1[5]);
        a1[6] = fmaf(xb, cb.z, a1[6]);
        a1[7] = fmaf(xb, cb.w, a1[7]);
      }
#pragma unroll
      for (int t = 0; t < SC_GROUP; ++t) {
        const int j = g + t;
        if (cvf[j] != 0.0f) {
          m0 = fminf(m0, fmaxf((cn2[j] + p0) - 2.0f * a0[t], 0.0f));
          m1 = fminf(m1, fmaxf((cn2[j] + p1) - 2.0f * a1[t], 0.0f));
        }
      }
    }
    if (tid < nt) {
      const int i = base + tid;
      const float w = pw != nullptr ? pw[i] : 1.0f;
      const float ht = member[i] ? w * (1.0f / fmaxf(probs[i], 1e-30f)) : 0.0f;
      part += service_value(m0, ball, r2, half_mu) * ht;
    }
    if (tid + nthr < nt) {
      const int i = base + tid + nthr;
      const float w = pw != nullptr ? pw[i] : 1.0f;
      const float ht = member[i] ? w * (1.0f / fmaxf(probs[i], 1e-30f)) : 0.0f;
      part += service_value(m1, ball, r2, half_mu) * ht;
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < nthr / 32; ++w) s += red[w];
    out[q] = s;
  }
}

extern "C" int repro_servicecost(const void* pts, const void* probs,
                                 const void* member, const void* pw,
                                 const void* ctr, const void* cvalid,
                                 const void* mu, const void* param,
                                 const void* mode, void* out, int c, int dim,
                                 int q, int cmax, int threads, int smem,
                                 void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        servicecost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  servicecost_kernel<<<q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(probs),
      static_cast<const uint8_t*>(member), static_cast<const float*>(pw),
      static_cast<const float*>(ctr), static_cast<const uint8_t*>(cvalid),
      static_cast<const float*>(mu), static_cast<const float*>(param),
      static_cast<const int32_t*>(mode), static_cast<float*>(out), c, dim,
      cmax);
  return static_cast<int>(cudaGetLastError());
}
