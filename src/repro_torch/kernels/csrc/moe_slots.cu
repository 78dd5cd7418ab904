// K8: the MoE's slot count, the slot, keep and destination of each of a
// row's S*k expert choices.
//
// Replaces no TPU kernel: the reference's slot assignment
// (src/repro/models/moe.py, "slot assignment") is plain JAX, an int32
// cumsum of a [B, S*k, E] one-hot along the choices. The port ran the same
// (kernels/moe_slots.py `expert_slots_plain`), which PyTorch scans with one
// thread per (row, expert) column: 128 threads at granite's [4, 32,768],
// E 32, each walking 32,768 dependent int64 elements (~11.7 ms a call).
// For each row b and choice i of flat_e [B, n] (int64, ids in [0, E)):
//   slot[b, i] = #{j < i : flat_e[b, j] == flat_e[b, i]}
//   keep       = slot < C
//   dest       = keep ? flat_e * C + slot : E * C
// Integers only, so the result is the plain version's to the bit.
//
// Bound on the H100: latency. The call reads 8n bytes a row and writes
// 17n (1 MB and 2.2 MB at granite's shape, ~1 us at 3.35 TB/s), under the
// launch floor. So the design is about parallelism:
//   - the row is cut into tiles of TILE choices (the wrapper picks TILE
//     from n: 32 tiles a row, 256..8192 choices), one block of 8 warps a
//     tile, grid (tiles, B); each warp owns TILE / 8 consecutive choices;
//   - a warp ranks 32 choices at a time with __match_any_sync (the lanes
//     that chose the same expert) and __popc(peers & lanes below), on top
//     of its running per-expert count in shared memory, which the lowest
//     lane of each group then advances;
//   - an exclusive scan over the block's 8 warps, per expert, gives each
//     warp its base inside the tile;
//   - the tile's base per expert is the sum of the counts of the row's
//     earlier tiles. A first launch (the count pass, this kernel without
//     the writes) stores each tile's counts to scratch [B, tiles, E]; the
//     second launch sums them for its tile and writes. A row of one tile
//     (decode, short prompts) takes the second launch alone. A decoupled
//     look-back would save the second launch's gap (a few us a call) at the
//     price of blocks that spin on each other's flags; two launches never
//     wait on another block.
// Ids outside [0, E) (route never gives one; the plain version raises on
// them) are not counted and get slot -1, keep false, dest E * C.
#include "common.cuh"

#define SLOT_THREADS 256
#define SLOT_WARPS (SLOT_THREADS / 32)
#define SLOT_VMAX 32                 // choices a lane holds: TILE <= 8192
#define SLOT_MAX_EXPERTS 1024        // shared counts: 8 x E int32 <= 32 KB

template <bool WRITE>
__global__ void __launch_bounds__(SLOT_THREADS)
moe_slots_kernel(const long long* __restrict__ flat_e,
                 int32_t* __restrict__ counts, long long* __restrict__ slot,
                 bool* __restrict__ keep, long long* __restrict__ dest, int n,
                 int E, int C, int tile) {
  extern __shared__ int32_t cnt[];   // [SLOT_WARPS][E]
  const int t = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = tile / SLOT_WARPS;
  const int v = per_warp / 32;
  const size_t row = static_cast<size_t>(b) * n;
  const int first = t * tile + warp * per_warp;
  const unsigned below = (1u << lane) - 1u;
  for (int j = threadIdx.x; j < SLOT_WARPS * E; j += SLOT_THREADS) cnt[j] = 0;

  int ex[SLOT_VMAX];
#pragma unroll
  for (int i = 0; i < SLOT_VMAX; ++i) {
    if (i < v) {
      const int idx = first + i * 32 + lane;
      const long long e = idx < n ? flat_e[row + idx] : -1;
      ex[i] = e >= 0 && e < E ? static_cast<int>(e) : -1;
    }
  }
  __syncthreads();

  // each choice's rank among its warp's earlier choices of the same expert
  int32_t* mine = cnt + warp * E;
  int rank[SLOT_VMAX];
#pragma unroll
  for (int i = 0; i < SLOT_VMAX; ++i) {
    if (i < v) {                      // v is the same in every lane
      const unsigned peers = __match_any_sync(0xffffffffu, ex[i]);
      rank[i] = ex[i] >= 0 ? mine[ex[i]] + __popc(peers & below) : 0;
      __syncwarp();
      if (ex[i] >= 0 && (peers & below) == 0) mine[ex[i]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // per expert: the tile's base (the row's earlier tiles), then an
  // exclusive scan over the warps; the count pass stores the tile's total
  int32_t* row_counts = counts + static_cast<size_t>(b) * tiles * E;
  for (int e = threadIdx.x; e < E; e += SLOT_THREADS) {
    int base = 0;
    if (WRITE) {
#pragma unroll 8
      for (int u = 0; u < t; ++u) base += row_counts[u * E + e];
    }
    for (int w = 0; w < SLOT_WARPS; ++w) {
      const int c = cnt[w * E + e];
      cnt[w * E + e] = base;
      base += c;
    }
    if (!WRITE) row_counts[t * E + e] = base;
  }
  if (!WRITE) return;
  __syncthreads();

  const long long drop = static_cast<long long>(E) * C;
#pragma unroll
  for (int i = 0; i < SLOT_VMAX; ++i) {
    if (i < v) {
      const int idx = first + i * 32 + lane;
      if (idx < n) {
        const int e = ex[i];
        const long long s = e >= 0 ? mine[e] + rank[i] : -1;
        const bool k = e >= 0 && s < C;
        slot[row + idx] = s;
        keep[row + idx] = k;
        dest[row + idx] = k ? static_cast<long long>(e) * C + s : drop;
      }
    }
  }
}

// flat_e [B, n] int64; slot, dest [B, n] int64; keep [B, n] bool; counts:
// int32 scratch of B * ceil(n / tile) * E words (unused, may be NULL, when
// n <= tile). tile: a multiple of 256 up to 8192.
extern "C" int repro_moe_slots(const void* flat_e, void* counts, void* slot,
                               void* keep, void* dest, int B, int n, int E,
                               int C, int tile, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || E < 1 || E > SLOT_MAX_EXPERTS ||
      C < 0 || tile < SLOT_THREADS || tile > SLOT_THREADS * SLOT_VMAX ||
      tile % SLOT_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + tile - 1) / tile;
  const dim3 grid(tiles, B);
  const size_t smem = SLOT_WARPS * static_cast<size_t>(E) * sizeof(int32_t);
  const long long* fe = static_cast<const long long*>(flat_e);
  int32_t* cn = static_cast<int32_t*>(counts);
  if (tiles > 1) {
    if (!cn) return static_cast<int>(cudaErrorInvalidValue);
    moe_slots_kernel<false><<<grid, SLOT_THREADS, smem, st>>>(
        fe, cn, nullptr, nullptr, nullptr, n, E, C, tile);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_slots_kernel<true><<<grid, SLOT_THREADS, smem, st>>>(
      fe, cn, static_cast<long long*>(slot), static_cast<bool*>(keep),
      static_cast<long long*>(dest), n, E, C, tile);
  return static_cast<int>(cudaGetLastError());
}
