// Two measurements behind the K4 and K5 designs, on one card:
// - the fp32 FMA rate of K5's register tile (R slots x G centers a lane,
//   4 dimensions a step) with its operands in registers and, as in K5,
//   read from shared memory (float4 rows at a stride of 4 x odd words;
//   the centers broadcast to the warp);
// - how many 8-block thread-block clusters of one block per SM can be
//   resident at once (cudaOccupancyMaxActiveClusters), i.e. how many SMs
//   such a cluster launch can use.
// Built and run by tools/kernel_probe.py; not part of the package.
#include <cuda_runtime.h>

template <int R, int G>
__global__ void reg_tile(float* out, int iters, float s) {
  float x[R][4], c[G][4], a[R][G];
  for (int r = 0; r < R; ++r)
    for (int k = 0; k < 4; ++k) x[r][k] = threadIdx.x * 1e-3f + r + k;
  for (int t = 0; t < G; ++t)
    for (int k = 0; k < 4; ++k) c[t][k] = 0.5f + t * 0.01f + k;
  for (int r = 0; r < R; ++r)
    for (int t = 0; t < G; ++t) a[r][t] = 0.0f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < G; ++t) a[r][t] = fmaf(x[r][k], c[t][k], a[r][t]);
    x[0][0] += s;
  }
  float z = 0.0f;
  for (int r = 0; r < R; ++r)
    for (int t = 0; t < G; ++t) z += a[r][t];
  out[blockIdx.x * blockDim.x + threadIdx.x] = z;
}

template <int R, int G>
__global__ void smem_tile(float* out, int iters, int nd4, int st) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < (32 * R + G) * st; e += blockDim.x)
    sm[e] = 1e-3f * (e % 97);
  __syncthreads();
  const float* xr = sm + lane * st;
  const float* cg = sm + 32 * R * st;
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float a[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < G; ++t) a[r][t] = 0.0f;
#pragma unroll 2
    for (int d4 = 0; d4 < nd4; ++d4) {
      float4 x[R], cc[G];
#pragma unroll
      for (int r = 0; r < R; ++r)
        x[r] = *reinterpret_cast<const float4*>(xr + r * 32 * st + 4 * d4);
#pragma unroll
      for (int t = 0; t < G; ++t)
        cc[t] = *reinterpret_cast<const float4*>(cg + t * st + 4 * d4);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < G; ++t) {
          a[r][t] = fmaf(x[r].x, cc[t].x, a[r][t]);
          a[r][t] = fmaf(x[r].y, cc[t].y, a[r][t]);
          a[r][t] = fmaf(x[r].z, cc[t].z, a[r][t]);
          a[r][t] = fmaf(x[r].w, cc[t].w, a[r][t]);
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < G; ++t) acc = fminf(acc, a[r][t]);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <typename F>
static float timed(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch();  // warm
  cudaEventRecord(e0);
  launch();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}

// which: 0 registers R4 G8, 1 shared R4 G8 (K5's loop), 2 shared R8 G8,
// 3 shared R4 G4; returns ms of one launch of blocks x 128 threads
extern "C" float probe_tile(int which, int blocks, int iters, int nd4,
                            int st) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * 128);
  float ms = -2.0f;
  const int sm48 = (32 * 4 + 8) * st * 4, sm88 = (32 * 8 + 8) * st * 4,
            sm44 = (32 * 4 + 4) * st * 4;
  cudaFuncSetAttribute(smem_tile<4, 8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, sm48);
  cudaFuncSetAttribute(smem_tile<8, 8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, sm88);
  cudaFuncSetAttribute(smem_tile<4, 4>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, sm44);
  if (which == 0)
    ms = timed([&] { reg_tile<4, 8><<<blocks, 128>>>(out, iters, 1e-7f); });
  if (which == 1)
    ms = timed([&] {
      smem_tile<4, 8><<<blocks, 128, sm48>>>(out, iters, nd4, st);
    });
  if (which == 2)
    ms = timed([&] {
      smem_tile<8, 8><<<blocks, 128, sm88>>>(out, iters, nd4, st);
    });
  if (which == 3)
    ms = timed([&] {
      smem_tile<4, 4><<<blocks, 128, sm44>>>(out, iters, nd4, st);
    });
  cudaFree(out);
  return ms;
}

__global__ void cluster_probe(int* out) {
  if (threadIdx.x == 0) out[blockIdx.x] = 1;
}

// resident clusters of `size` blocks, each block holding `smem` bytes of
// dynamic shared memory (enough for one block per SM)
extern "C" int probe_clusters(int size, int smem) {
  cudaFuncSetAttribute(cluster_probe,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size * 64, 1, 1);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, cluster_probe, &cfg) != cudaSuccess)
    return -1;
  return n;
}
