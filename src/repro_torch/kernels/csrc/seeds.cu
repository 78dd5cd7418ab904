// K1: fused f-seeds (and, when asked, f-values) for every objective in one
// pass.
//
// Replaces the TPU kernel src/repro/kernels/seeds.py `_seeds_kernel`
// (pallas_call in `_fused_seeds`): hash(key, seed) -> u -> r
// (ppswor: -log1p(-u), priority: u) -> per objective j the seed r / f_j(w)
// (+inf when inactive or f_j(w) = 0) and, with want_fvals, f_j(w) masked
// to 0 when inactive. Without want_fvals only the seeds are written, as
// the reference's `fused_seeds` does.
//
// Bound on the H100: bytes. Each row reads 9 bytes (key, weight, active)
// and writes 4 * F bytes of seeds, plus 4 * F of f-values when asked. The
// arithmetic per row (two fmix32 rounds, one log1pf, up to F IEEE
// divisions and a libdevice powf per moment objective) is close enough to
// the byte time that it has to be kept out of the way. Design:
//  * each thread takes 4 consecutive rows: one 16-byte load of keys, one
//    of weights and one 4-byte load of the active bytes (scalar loads for
//    the last partial quad or unaligned inputs), and keeps r, w and the
//    active flags of its rows in registers;
//  * the loop over objectives is outside the rows: each objective's kind
//    is read once (the objectives are a __grid_constant__ argument, read
//    in place) and dispatched once for the thread's 4 rows;
//  * count and thresh have f = 1 wherever they are positive, and r / 1 is
//    r exactly, so their seed is r with no division; every other division
//    and every powf stays the IEEE / libdevice one (no fast math);
//  * each output row j of the contiguous [F, n] arrays starts at element
//    j * n, which is 16-byte aligned only when j * n is a multiple of 4.
//    Row j's first h_j elements (its aligned head's offset) are shifted
//    into place with warp shuffles, so every lane stores one aligned
//    float4; lane 0 of each warp writes the h_j elements before its first
//    aligned quad and lane 31 the 4 - h_j after its last, as scalars, and
//    a partial quad at the end of a row is written as scalars;
//  * seeds are written with plain stores and f-values with evict-first
//    ones (__stcs): at F = 8 the 34 MB of seeds fit the 50 MB L2, where
//    K2, which reads them next, finds them;
//  * the grid is at most the SM count times the resident blocks per SM
//    (from the occupancy API; __launch_bounds__ keeps 8 blocks of 256
//    resident, so the 1,033 tiles of 1024 rows of the shard fold run in
//    one wave), walking tiles of 1024 rows;
//  * where n gives fewer 4-row tiles than SMs (the 16,402-row upkeep fold:
//    17 tiles), the launch is bound by latency, not bytes: the same kernel
//    runs with one row per thread (scalar loads and stores), which spreads
//    the rows over 4x as many threads and SMs.
// The hash seed and the objective list are runtime arguments, so one
// binary serves every spec.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;                 // resident blocks: 32 registers
constexpr int kRows = 4;                      // consecutive rows per thread
constexpr int kTile = kThreads * kRows;
constexpr unsigned kFull = 0xffffffffu;

struct Quad {
  float v[kRows];
};

// Store one objective's values of the thread's rows [base, base + 4) into
// the output row `row`, as aligned float4s. h (0..3, the same in every
// thread for one objective) is the element of `row` at which its first
// 16-byte boundary lies; base is a multiple of 4, so row + base + h is
// aligned. kStream: write with __stcs (evict-first).
template <bool kStream>
__device__ __forceinline__ void store(float* p, float x) {
  if (kStream) __stcs(p, x); else *p = x;
}

template <bool kStream>
__device__ __forceinline__ void store_row(float* __restrict__ row, int h,
                                          const Quad& q, long long base,
                                          long long n, int lane) {
  // o[k] = the value of row base + h + k; the rows past base + 3 are the
  // next lane's first h values
  float o[kRows];
  switch (h) {
    case 0:
      o[0] = q.v[0]; o[1] = q.v[1]; o[2] = q.v[2]; o[3] = q.v[3];
      break;
    case 1:
      o[0] = q.v[1]; o[1] = q.v[2]; o[2] = q.v[3];
      o[3] = __shfl_down_sync(kFull, q.v[0], 1);
      break;
    case 2:
      o[0] = q.v[2]; o[1] = q.v[3];
      o[2] = __shfl_down_sync(kFull, q.v[0], 1);
      o[3] = __shfl_down_sync(kFull, q.v[1], 1);
      break;
    default:
      o[0] = q.v[3];
      o[1] = __shfl_down_sync(kFull, q.v[0], 1);
      o[2] = __shfl_down_sync(kFull, q.v[1], 1);
      o[3] = __shfl_down_sync(kFull, q.v[2], 1);
      break;
  }
  const long long r0 = base + h;
  if (h == 0 || lane != 31) {
    if (r0 + kRows <= n) {
      const float4 x = make_float4(o[0], o[1], o[2], o[3]);
      float4* p = reinterpret_cast<float4*>(row + r0);
      if (kStream) __stcs(p, x); else *p = x;
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < n) store<kStream>(row + r0 + k, o[k]);
    }
  }
  if (h != 0 && (lane == 0 || lane == 31)) {
    // lane 0: the h rows before its first aligned quad; lane 31: the
    // 4 - h rows after its last (the next warp's lane 0 has the rest)
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if ((lane == 0) == (k < h) && base + k < n)
        store<kStream>(row + base + k, q.v[k]);
  }
}

// the shift that puts a quad of `row` on a 16-byte boundary
__device__ __forceinline__ int align_shift(const float* row) {
  return static_cast<int>((4u - ((reinterpret_cast<uintptr_t>(row) >> 2)
                                 & 3u)) & 3u);
}

// seed (and f-value) of R rows for one objective of kind KIND; count and
// thresh skip the division (r / 1 == r)
template <int R, int KIND>
__device__ __forceinline__ void objective_rows(const float (&wi)[R],
                                               const bool (&act)[R],
                                               const float (&r)[R],
                                               float param, float (&s)[R],
                                               float (&f)[R]) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (KIND == 1 || KIND == 2) {
      const bool pos = KIND == 1 ? wi[k] > 0.0f : wi[k] >= param;
      s[k] = (act[k] && pos) ? r[k] : inf;
      f[k] = (act[k] && pos) ? 1.0f : 0.0f;
    } else {
      const float fv = KIND == 0 ? wi[k]
                       : KIND == 3 ? fminf(wi[k], param)
                                   : stat_fval(4, param, wi[k]);
      s[k] = (act[k] && fv > 0.0f) ? r[k] / fmaxf(fv, 1e-30f) : inf;
      f[k] = act[k] ? fv : 0.0f;
    }
  }
}

// R rows per thread: 4 (16-byte loads, shifted float4 stores) for large n,
// 1 (one row per thread, scalar loads and stores) where n is too small to
// give every SM a 4-row tile: there the work is latency-bound and the
// rows are better spread over more threads.
template <int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seeds_kernel(const int32_t* __restrict__ keys, const float* __restrict__ w,
             const uint8_t* __restrict__ active, float* __restrict__ seeds,
             float* __restrict__ fvals, int n_rows,
             const __grid_constant__ Objectives obj, uint32_t seed,
             int ppswor, int vec_in) {
  const long long n = n_rows;
  const int lane = threadIdx.x & 31;
  constexpr int tile_rows = kThreads * R;
  for (long long tile = static_cast<long long>(blockIdx.x) * tile_rows;
       tile < n; tile += static_cast<long long>(gridDim.x) * tile_rows) {
    const long long base = tile + threadIdx.x * R;
    uint32_t key[R];
    float wi[R];
    bool act[R];
    if (R == kRows && vec_in && base + R <= n) {
      const int4 k4 = *reinterpret_cast<const int4*>(keys + base);
      const float4 w4 = *reinterpret_cast<const float4*>(w + base);
      const uint32_t a4 = *reinterpret_cast<const uint32_t*>(active + base);
      const uint32_t kv[4] = {static_cast<uint32_t>(k4.x),
                              static_cast<uint32_t>(k4.y),
                              static_cast<uint32_t>(k4.z),
                              static_cast<uint32_t>(k4.w)};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < R; ++k) {
        key[k] = kv[k];
        wi[k] = wv[k];
        act[k] = ((a4 >> (8 * k)) & 0xffu) != 0;
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const bool in = base + k < n;
        key[k] = in ? static_cast<uint32_t>(keys[base + k]) : 0u;
        wi[k] = in ? w[base + k] : 0.0f;
        act[k] = in && active[base + k] != 0;
      }
    }
    float r[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const uint32_t hv = hash_u32(key[k], seed);
      float u = static_cast<float>(hv >> 8) * (1.0f / 16777216.0f);
      u = u + (0.5f / 16777216.0f);
      r[k] = ppswor ? -log1pf(-u) : u;
    }
#pragma unroll 1
    for (int j = 0; j < obj.nf; ++j) {
      const float param = obj.param[j];
      float s[R], f[R];
      switch (obj.kind[j]) {
        case 0: objective_rows<R, 0>(wi, act, r, param, s, f); break;
        case 1: objective_rows<R, 1>(wi, act, r, param, s, f); break;
        case 2: objective_rows<R, 2>(wi, act, r, param, s, f); break;
        case 3: objective_rows<R, 3>(wi, act, r, param, s, f); break;
        default: objective_rows<R, 4>(wi, act, r, param, s, f); break;
      }
      float* srow = seeds + static_cast<long long>(j) * n;
      float* frow = fvals == nullptr ? nullptr
                                     : fvals + static_cast<long long>(j) * n;
      if constexpr (R == kRows) {
        const Quad sq = {{s[0], s[1], s[2], s[3]}};
        store_row<false>(srow, align_shift(srow), sq, base, n, lane);
        if (frow != nullptr) {
          const Quad fq = {{f[0], f[1], f[2], f[3]}};
          store_row<true>(frow, align_shift(frow), fq, base, n, lane);
        }
      } else if (base < n) {
        store<false>(srow + base, s[0]);
        if (frow != nullptr) store<true>(frow + base, f[0]);
      }
    }
  }
}

struct Limits {
  int sms = 0, blocks4 = 0, blocks1 = 0;
};

// SM count and resident blocks of each variant on the current device,
// cached per device
const Limits& limits() {
  static Limits cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  Limits& l = cached[dev];
  if (l.sms == 0) {
    int sms = 0, per4 = 0, per1 = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per4, seeds_kernel<kRows>,
                                                  kThreads, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per1, seeds_kernel<1>,
                                                  kThreads, 0);
    sms = sms > 0 ? sms : 132;
    l.blocks4 = sms * (per4 > 0 ? per4 : 1);
    l.blocks1 = sms * (per1 > 0 ? per1 : 1);
    l.sms = sms;
  }
  return l;
}

}  // namespace

// fvals may be NULL: seeds only.
extern "C" int repro_seeds(const void* keys, const void* w,
                           const void* active, void* seeds, void* fvals,
                           int n, int nf, const void* kinds,
                           const void* params, uint32_t seed, int ppswor,
                           void* stream) {
  const Objectives obj = make_objectives(
      nf, static_cast<const int*>(kinds), static_cast<const float*>(params));
  const bool vec_in = (reinterpret_cast<uintptr_t>(keys) % 16 == 0)
                      && (reinterpret_cast<uintptr_t>(w) % 16 == 0)
                      && (reinterpret_cast<uintptr_t>(active) % 4 == 0);
  const Limits& lim = limits();
  const long long tiles4 = (static_cast<long long>(n) + kTile - 1) / kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles4 >= lim.sms) {
    const int blocks = static_cast<int>(tiles4 < lim.blocks4 ? tiles4
                                                             : lim.blocks4);
    seeds_kernel<kRows><<<blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(w),
        static_cast<const uint8_t*>(active), static_cast<float*>(seeds),
        static_cast<float*>(fvals), n, obj, seed, ppswor, vec_in ? 1 : 0);
  } else {
    const long long tiles1 = (static_cast<long long>(n) + kThreads - 1)
                             / kThreads;
    const int blocks = static_cast<int>(
        tiles1 < 1 ? 1 : (tiles1 < lim.blocks1 ? tiles1 : lim.blocks1));
    seeds_kernel<1><<<blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(w),
        static_cast<const uint8_t*>(active), static_cast<float*>(seeds),
        static_cast<float*>(fvals), n, obj, seed, ppswor, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
