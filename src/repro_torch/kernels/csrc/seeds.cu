// K1: fused f-seeds (+ f-values) for every objective in one pass.
//
// Replaces the TPU kernel src/repro/kernels/seeds.py `_seeds_kernel`
// (pallas_call in `_fused_seeds`): hash(key, seed) -> u -> r
// (ppswor: -log1p(-u), priority: u) -> per objective j the seed r / f_j(w)
// (+inf when inactive or f_j(w) = 0) and f_j(w) masked to 0 when inactive.
//
// Bound on the H100: bytes. Each row reads 9 bytes (key, weight, active)
// and writes 8 * F bytes (seed and f-value per objective); the arithmetic
// (two fmix32 rounds, one log1pf, F divisions) is far below the card's
// rate. Design: one thread per row in a grid-stride loop, every load and
// store coalesced along n (row j of the [F, n] outputs is contiguous), the
// objectives passed by value so the per-row loop over F reads no memory.
// The hash seed and the objective list are runtime arguments, so one
// binary serves every spec.
#include "common.cuh"

__global__ void seeds_kernel(const int32_t* __restrict__ keys,
                             const float* __restrict__ w,
                             const uint8_t* __restrict__ active,
                             float* __restrict__ seeds,
                             float* __restrict__ fvals, int n,
                             Objectives obj, uint32_t seed, int ppswor) {
  const float inf = __int_as_float(0x7f800000);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint32_t h = hash_u32(static_cast<uint32_t>(keys[i]), seed);
    float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
    u = u + (0.5f / 16777216.0f);
    const float r = ppswor ? -log1pf(-u) : u;
    const float wi = w[i];
    const bool act = active[i] != 0;
#pragma unroll
    for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j) {
      if (j < obj.nf) {
        const float fv = stat_fval(obj.kind[j], obj.param[j], wi);
        const size_t o = static_cast<size_t>(j) * n + i;
        seeds[o] = (act && fv > 0.0f) ? r / fmaxf(fv, 1e-30f) : inf;
        fvals[o] = act ? fv : 0.0f;
      }
    }
  }
}

extern "C" int repro_seeds(const void* keys, const void* w,
                           const void* active, void* seeds, void* fvals,
                           int n, int nf, const void* kinds,
                           const void* params, uint32_t seed, int ppswor,
                           void* stream) {
  const Objectives obj = make_objectives(
      nf, static_cast<const int*>(kinds), static_cast<const float*>(params));
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  seeds_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(w),
      static_cast<const uint8_t*>(active), static_cast<float*>(seeds),
      static_cast<float*>(fvals), n, obj, seed, ppswor);
  return static_cast<int>(cudaGetLastError());
}
