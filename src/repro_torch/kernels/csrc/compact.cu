// K3: fused dedup + retention priority over key-sorted slab candidates.
//
// Replaces the TPU kernel src/repro/kernels/compact.py `_priority_kernel`
// (pallas_call in `retention_priority`): an entry is a duplicate when its
// key equals the previous key or is negative; kept non-duplicates get
// priority 1/(1+w) (members) or 2 + 1/(1+w) (aux), everything else +inf.
//
// Bound on the H100: bytes (4 key + 1 member + 1 keep + 4 weight read,
// 4 priority written per row). Design: one thread per row, coalesced
// loads; the previous key is read as keys[i-1] (an L1/L2 hit on the
// neighbouring thread's load) instead of being materialised as a second
// input array as the TPU version did, with -2 before row 0.
#include "common.cuh"

__global__ void priority_kernel(const int32_t* __restrict__ keys,
                                const uint8_t* __restrict__ member,
                                const uint8_t* __restrict__ keep,
                                const float* __restrict__ w,
                                float* __restrict__ pri, int n) {
  const float inf = __int_as_float(0x7f800000);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int32_t k = keys[i];
    const int32_t prev = i > 0 ? keys[i - 1] : -2;
    const bool dup = k == prev || k < 0;
    const bool kp = keep[i] != 0 && !dup;
    const float inv = 1.0f / (1.0f + fmaxf(w[i], 0.0f));
    const float p = member[i] != 0 ? inv : 2.0f + inv;
    pri[i] = kp ? p : inf;
  }
}

extern "C" int repro_priority(const void* keys, const void* member,
                              const void* keep, const void* w, void* pri,
                              int n, void* stream) {
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  priority_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(keep), static_cast<const float*>(w),
      static_cast<float*>(pri), n);
  return static_cast<int>(cudaGetLastError());
}
