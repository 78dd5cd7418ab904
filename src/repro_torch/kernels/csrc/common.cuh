// Shared device helpers of the repro_torch kernels: the fmix32 hash and the
// statistic functions f(w), bit-for-bit the arithmetic of the JAX package's
// kernels/seeds.py (_mix, _fval) and of the port's plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_MAX_OBJECTIVES 8

// objectives travel by value in the kernel's argument block: (kind, param)
// with kind 0=sum, 1=count, 2=thresh(T), 3=cap(T), 4=moment(p)
struct Objectives {
  int nf;
  int kind[REPRO_MAX_OBJECTIVES];
  float param[REPRO_MAX_OBJECTIVES];
};

static inline Objectives make_objectives(int nf, const int* kinds,
                                         const float* params) {
  Objectives o;
  o.nf = nf;
  for (int j = 0; j < REPRO_MAX_OBJECTIVES; ++j) {
    o.kind[j] = j < nf ? kinds[j] : 0;
    o.param[j] = j < nf ? params[j] : 0.0f;
  }
  return o;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// hash_u32(key, seed): two fmix32 rounds keyed by the seed
__device__ __forceinline__ uint32_t hash_u32(uint32_t key, uint32_t seed) {
  uint32_t h = fmix32(key + 0x9E3779B9u + seed);
  return fmix32(h ^ (seed * 0x85EBCA6Bu + 1u));
}

__device__ __forceinline__ float stat_fval(int kind, float param, float w) {
  switch (kind) {
    case 0: return w;
    case 1: return w > 0.0f ? 1.0f : 0.0f;
    case 2: return w >= param ? 1.0f : 0.0f;
    case 3: return fminf(w, param);
    default: return w > 0.0f ? powf(fmaxf(w, 1e-30f), param) : 0.0f;
  }
}

// The cross-block step of a kernel that splits a reduction over `nranks`
// blocks of one tile (blockIdx.x = rank): each block stores its partials
// to global scratch, then calls this. It returns true, in every thread, in
// the one block that finishes the tile last; that block reads the tile's
// partials back with __ldcg (from L2, past the non-coherent L1) and adds
// them in rank order, so the sum is the same whichever block finishes
// last. The atomic only elects that block (a ticket per tile, reset to 0
// for the next launch); no sum is ever formed by atomics.
__device__ __forceinline__ bool last_block_of_tile(unsigned int* ticket,
                                                   int nranks) {
  __shared__ bool last;
  __threadfence();  // this thread's partials are visible device-wide
  __syncthreads();  // ... and every thread's
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(nranks - 1);
    if (last) *ticket = 0u;  // no other block of this launch touches it
  }
  __syncthreads();
  return last;
}
