// K6: all-pairs rank counts for universal sample membership.
//
// Replaces the TPU kernel src/repro/kernels/rankcount.py `_rankcount_kernel`
// (pallas_call in `rank_counts`). Over the pairs where x and y are both
// active:
//   h_x = #{y : w_y >= w_x  and  s_h,y < s_h,x}     (monotone, Lemma 5.1)
//   l_x = #{y : w_y <  w_x  and  s_l,y < s_l,x}     (capping, Lemma 6.3)
// The strict < on both seeds means the diagonal never counts itself.
//
// Bound on the H100: operations. About 4 per ordered pair (a weight
// comparison, two seed comparisons, one count update), n^2 pairs: at
// n = 2^20, 4.4e12 operations, 66 ms at 67 TFLOP/s fp32. The bytes are
// negligible (16 bytes in and 8 out per key: 16 MB and 8 MB at 2^20).
//
// Design (a simple one first): one thread per x, holding w_x, s_h,x and
// s_l,x in registers and its two counts as int32; y streams through
// shared memory in tiles of blockDim.x entries stored as float4
// (w, s_h, s_l, 0) that every thread of the block reads as a broadcast.
// An inactive or out-of-range y is staged with w = NaN: both weight
// comparisons are false for NaN, so it never counts and the inner loop
// needs no activity test. An inactive x writes 0. Bounds checks replace
// the Pallas padding; there are no atomics, so the counts are exact and
// equal the plain version's.
#include "common.cuh"

__global__ void rankcount_kernel(const float* __restrict__ w,
                                 const float* __restrict__ s_h,
                                 const float* __restrict__ s_l,
                                 const uint8_t* __restrict__ active,
                                 int32_t* __restrict__ h_out,
                                 int32_t* __restrict__ l_out, int n) {
  extern __shared__ float4 tile[];
  const float nan = __int_as_float(0x7fc00000);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const bool x_in = x < n;
  const bool x_act = x_in && active[x] != 0;
  const float wx = x_in ? w[x] : 0.0f;
  const float hx = x_in ? s_h[x] : 0.0f;
  const float lx = x_in ? s_l[x] : 0.0f;
  int32_t h = 0, l = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int y = base + threadIdx.x;
    float4 v = make_float4(nan, 0.0f, 0.0f, 0.0f);
    if (y < n && active[y] != 0) v = make_float4(w[y], s_h[y], s_l[y], 0.0f);
    __syncthreads();
    tile[threadIdx.x] = v;
    __syncthreads();
    const int m = min(static_cast<int>(blockDim.x), n - base);
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float4 t = tile[j];
      h += (t.x >= wx) & (t.y < hx);
      l += (t.x < wx) & (t.z < lx);
    }
  }
  if (x_in) {
    h_out[x] = x_act ? h : 0;
    l_out[x] = x_act ? l : 0;
  }
}

extern "C" int repro_rankcount(const void* w, const void* s_h,
                               const void* s_l, const void* active, void* h,
                               void* l, int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  rankcount_kernel<<<blocks, threads, threads * sizeof(float4),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(s_h),
      static_cast<const float*>(s_l), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(h), static_cast<int32_t*>(l), n);
  return static_cast<int>(cudaGetLastError());
}
