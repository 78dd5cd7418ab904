// K2, global route: the exact per-row bottom-k of a [F, n] seed matrix, for
// `batched_bottomk_select`.
//
// Replaces, on the main path, the TPU kernel src/repro/kernels/blockselect.py
// `_blockselect_kernel` (pallas_call in `batched_block_bottomk`) and the
// second-stage selection over its per-span candidates. The TPU kernel runs
// k min-and-mask rounds per 2048-slot span, which assumes k << span; the
// main path asks for q = k + 1 = 1026 of each span (multisketch_select) or
// the whole span (compact_take), so a per-span form writes half or all of
// its input back as candidates. Here each row is selected as a whole.
//
// Bound on the H100: bytes. Every seed is read once (4 bytes) and k + 1
// (value, index) pairs are written per row. The kernels read each row five
// times (three radix passes, a count, a write); the rank sort does q^2
// comparisons of the q = k + 1 candidates (67M at q = 8202).
//
// Design. A seed maps to an order-preserving uint32 key (-0.0 ties with
// +0.0 and every NaN sorts last, as torch.sort compares them). Three radix
// passes over bits [21, 32), [10, 21) and [0, 10) find, per row, the key T
// of the q-th smallest seed (q = min(k + 1, n)) and the count c_lt of seeds
// below it: each block builds a shared-memory histogram of the seeds whose
// key matches the prefix found so far and adds it into the row's global
// histogram with integer atomics (counts only); the block that finishes the
// row last (`last_block_of_tile`) scans the histogram, fixes the next digit
// in the row's state and zeroes the histogram for the next pass. A count
// pass stores every warp segment's and block's (#key < T, #key == T), and
// the row's last block turns the block counts into prefix sums in block
// order (a fixed sum, no scheduling order). The write pass gives each warp
// its output offset and its share of the q - c_lt seeds == T from them and
// writes, in index order, every seed < T and the first q - c_lt seeds == T:
// exactly q candidates, invalid (non-finite) ones with index -1. Last, for
// q <= RANK_Q_MAX, a rank kernel places each candidate at its count of
// (key, index)-smaller candidates, the order of a stable sort of the whole
// row (lowest index first among ties), and writes the reference's layout;
// past that the caller sorts the candidates (torch.sort, stable). No host
// synchronisation: the state stays on the device.
#include "common.cuh"

#define SELECT_THREADS 256
#define SELECT_WARPS (SELECT_THREADS / 32)
#define SELECT_ITEMS 8      // seeds a thread loads before it uses them
#define SELECT_BINS 2048
#define RANK_J 32           // candidates a block of the rank sort places
#define RANK_Q_MAX 16384    // candidates it stages (64 KB of keys)

// state per row: the key prefix found so far, the rank still sought inside
// it (1-based) and the count of keys below it
#define ST_PREFIX 0
#define ST_WANT 1
#define ST_LESS 2
#define ST_WIDTH 4

// scratch (zeroed, left zeroed): [nf, SELECT_BINS] histograms, then [nf]
// tickets
__device__ __forceinline__ unsigned int* row_ticket(unsigned int* scratch,
                                                    int row) {
  return scratch + gridDim.y * SELECT_BINS + row;
}

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if ((b & 0x7fffffffu) == 0u) b = 0u;                  // -0.0 == +0.0
  if ((b & 0x7fffffffu) > 0x7f800000u) b = 0x7fc00000u;  // NaN last
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// inclusive scan of an int2 over the block, in thread order; `total` gets
// the block's sum. Every thread calls it; it ends with a barrier.
__device__ int2 block_scan2(int2 v, int2* total) {
  __shared__ int2 wsum[SELECT_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int ax = __shfl_up_sync(0xffffffffu, v.x, off);
    const int ay = __shfl_up_sync(0xffffffffu, v.y, off);
    if (lane >= off) {
      v.x += ax;
      v.y += ay;
    }
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  int2 tot = make_int2(0, 0);
  for (int w = 0; w < SELECT_WARPS; ++w) {
    if (w < warp) {
      v.x += wsum[w].x;
      v.y += wsum[w].y;
    }
    tot.x += wsum[w].x;
    tot.y += wsum[w].y;
  }
  *total = tot;
  __syncthreads();
  return v;
}

// histogram pass PASS over every row (bits [21, 32), [10, 21), [0, 10) of
// the key)
template <int PASS>
__global__ void __launch_bounds__(SELECT_THREADS)
select_hist_kernel(const float* __restrict__ seeds, uint32_t* state,
                   unsigned int* scratch, int n, int q, int chunk) {
  constexpr int shift = PASS == 0 ? 21 : (PASS == 1 ? 10 : 0);
  constexpr int bits = PASS == 2 ? 10 : 11;
  constexpr int nbins = 1 << bits;
  constexpr int high = shift + bits;        // key bits fixed before this pass
  constexpr int hs = high < 32 ? high : 0;  // (a shift by 32 is undefined)
  constexpr int per = nbins / SELECT_THREADS;   // 8 or 4 bins a thread
  __shared__ unsigned int hist[nbins];
  const int row = blockIdx.y;
  uint32_t* st = state + row * ST_WIDTH;
  unsigned int* ghist = scratch + row * SELECT_BINS;
  const uint32_t prefix = PASS == 0 ? 0u : st[ST_PREFIX];
  for (int b = threadIdx.x; b < nbins; b += SELECT_THREADS) hist[b] = 0u;
  __syncthreads();
  const float* src = seeds + static_cast<size_t>(row) * n;
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  for (int base = lo; base < hi; base += SELECT_THREADS * SELECT_ITEMS) {
    uint32_t key[SELECT_ITEMS];
    bool in[SELECT_ITEMS];
#pragma unroll
    for (int u = 0; u < SELECT_ITEMS; ++u) {
      const int i = base + u * SELECT_THREADS + threadIdx.x;
      in[u] = i < hi;
      key[u] = in[u] ? order_key(src[i]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < SELECT_ITEMS; ++u) {
      if (!in[u] || (high < 32 && (key[u] >> hs) != (prefix >> hs)))
        continue;
      atomicAdd(&hist[(key[u] >> shift) & (nbins - 1)], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += SELECT_THREADS) {
    if (hist[b]) atomicAdd(&ghist[b], hist[b]);
  }
  if (!last_block_of_tile(row_ticket(scratch, row), gridDim.x)) return;

  // the last block of the row: find the bin that holds rank `want`, and
  // leave the histogram zeroed
  const int want = PASS == 0 ? q : static_cast<int>(st[ST_WANT]);
  const int less = PASS == 0 ? 0 : static_cast<int>(st[ST_LESS]);
  unsigned int v[per];
  uint4* g4 = reinterpret_cast<uint4*>(ghist + threadIdx.x * per);
#pragma unroll
  for (int j = 0; j < per / 4; ++j) {
    const uint4 x = __ldcg(g4 + j);
    v[4 * j] = x.x;
    v[4 * j + 1] = x.y;
    v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
    g4[j] = make_uint4(0u, 0u, 0u, 0u);
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < per; ++j) mine += static_cast<int>(v[j]);
  int2 tot;
  int cum = block_scan2(make_int2(mine, 0), &tot).x - mine;   // exclusive
  if (cum < want && want <= cum + mine) {
#pragma unroll
    for (int j = 0; j < per; ++j) {
      if (cum < want && want <= cum + static_cast<int>(v[j])) {
        const uint32_t digit = threadIdx.x * per + j;
        st[ST_PREFIX] = prefix | (digit << shift);
        st[ST_WANT] = static_cast<uint32_t>(want - cum);
        st[ST_LESS] = static_cast<uint32_t>(less + cum);
      }
      cum += static_cast<int>(v[j]);
    }
  }
}

// per block, COUNT_WIDTH ints of `counts`: the block's (#key < T,
// #key == T), which the row's last block turns into the sums over the
// blocks before it, then each warp segment's (#key < T, #key == T)
#define COUNT_WIDTH (2 + 2 * SELECT_WARPS)

// every warp counts its segment of chunk / SELECT_WARPS seeds
__global__ void __launch_bounds__(SELECT_THREADS)
select_count_kernel(const float* __restrict__ seeds,
                    const uint32_t* __restrict__ state,
                    int* __restrict__ counts, unsigned int* scratch, int n,
                    int chunk) {
  __shared__ int2 wc[SELECT_WARPS];
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = chunk / SELECT_WARPS;
  const uint32_t t = state[row * ST_WIDTH + ST_PREFIX];
  const float* src = seeds + static_cast<size_t>(row) * n;
  const int lo = blockIdx.x * chunk + warp * seg;
  const int hi = min(n, lo + seg);
  int lt = 0, eq = 0;
  for (int base = lo; base < hi; base += 32 * SELECT_ITEMS) {
    float v[SELECT_ITEMS];
#pragma unroll
    for (int u = 0; u < SELECT_ITEMS; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < hi ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SELECT_ITEMS; ++u) {
      const bool in = base + u * 32 + lane < hi;
      const uint32_t key = order_key(v[u]);
      lt += in && key < t;
      eq += in && key == t;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lt += __shfl_down_sync(0xffffffffu, lt, off);
    eq += __shfl_down_sync(0xffffffffu, eq, off);
  }
  int* rc = counts + static_cast<size_t>(row) * gridDim.x * COUNT_WIDTH;
  int* mine = rc + blockIdx.x * COUNT_WIDTH;
  if (lane == 0) {
    wc[warp] = make_int2(lt, eq);
    mine[2 + 2 * warp] = lt;
    mine[3 + 2 * warp] = eq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int w = 0; w < SELECT_WARPS; ++w) {
      a += wc[w].x;
      b += wc[w].y;
    }
    mine[0] = a;
    mine[1] = b;
  }
  if (!last_block_of_tile(row_ticket(scratch, row), gridDim.x)) return;

  // the last block of the row: exclusive scan over the blocks, in order
  int2 carry = make_int2(0, 0);
  for (int base = 0; base < static_cast<int>(gridDim.x);
       base += SELECT_THREADS) {
    const int b = base + threadIdx.x;
    int2 v = make_int2(0, 0);
    if (b < static_cast<int>(gridDim.x)) {
      v.x = __ldcg(&rc[b * COUNT_WIDTH]);
      v.y = __ldcg(&rc[b * COUNT_WIDTH + 1]);
    }
    int2 tot;
    const int2 inc = block_scan2(v, &tot);
    if (b < static_cast<int>(gridDim.x)) {
      rc[b * COUNT_WIDTH] = carry.x + inc.x - v.x;
      rc[b * COUNT_WIDTH + 1] = carry.y + inc.y - v.y;
    }
    carry.x += tot.x;
    carry.y += tot.y;
  }
}

// each warp writes its segment's candidates: in index order, every seed < T
// and seeds == T while the segment's share of them lasts
__global__ void __launch_bounds__(SELECT_THREADS)
select_write_kernel(const float* __restrict__ seeds,
                    const uint32_t* __restrict__ state,
                    const int* __restrict__ counts, float* __restrict__ vals,
                    int32_t* __restrict__ idx, int n, int q, int chunk) {
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = chunk / SELECT_WARPS;
  const uint32_t* st = state + row * ST_WIDTH;
  const int need = q - static_cast<int>(st[ST_LESS]);   // seeds == T taken
  const int* rc = counts + (static_cast<size_t>(row) * gridDim.x +
                            blockIdx.x) * COUNT_WIDTH;
  int lt_before = rc[0], eq_before = rc[1];
  for (int w = 0; w < warp; ++w) {
    lt_before += rc[2 + 2 * w];
    eq_before += rc[3 + 2 * w];
  }
  const int taken = min(need, eq_before);
  const uint32_t t = st[ST_PREFIX];
  int pos = lt_before + taken;            // this warp's next output slot
  int budget = need - taken;
  const float* src = seeds + static_cast<size_t>(row) * n;
  float* vout = vals + static_cast<size_t>(row) * q;
  int32_t* iout = idx + static_cast<size_t>(row) * q;
  const int lo = blockIdx.x * chunk + warp * seg;
  const int hi = min(n, lo + seg);
  const unsigned int below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32 * SELECT_ITEMS) {
    float v[SELECT_ITEMS];
#pragma unroll
    for (int u = 0; u < SELECT_ITEMS; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < hi ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SELECT_ITEMS; ++u) {
      const int i = base + u * 32 + lane;
      const uint32_t key = order_key(v[u]);
      const unsigned int bl = __ballot_sync(0xffffffffu, i < hi && key < t);
      const unsigned int be = __ballot_sync(0xffffffffu, i < hi && key == t);
      // lanes that take a seed == T: the first `budget` of them
      unsigned int take = be;
      if (__popc(be) > budget) {
        take = 0u;
        unsigned int rest = be;
        for (int c = 0; c < budget; ++c) {
          take |= rest & (0u - rest);
          rest &= rest - 1u;
        }
      }
      const unsigned int sel = bl | take;
      if ((sel >> lane) & 1u) {
        const int o = pos + __popc(sel & below);
        vout[o] = v[u];
        iout[o] = fabsf(v[u]) < __int_as_float(0x7f800000) ? i : -1;
      }
      pos += __popc(sel);
      budget -= __popc(take);
    }
  }
}

// sort the q candidates of each row (in index order) by rank: candidate j
// goes to #{i : (key_i, i) < (key_j, j)}, which is its place in a stable
// sort of the row. A block takes RANK_J candidates, a lane each, and its
// warps count over slices of the row's keys staged in shared memory; the
// slices' counts are added in warp order. Writes the reference's layout:
// vals, idx [nf, min(k, m)] padded with (+inf, -1) past q, and tau, the
// (k+1)-th smallest (+inf if m <= k).
__global__ void __launch_bounds__(SELECT_THREADS)
select_rank_kernel(const float* __restrict__ cvals,
                   const int32_t* __restrict__ cidx, float* __restrict__ vals,
                   int32_t* __restrict__ idx, float* __restrict__ tau, int q,
                   int m, int k) {
  extern __shared__ uint32_t skey[];
  __shared__ int part[SELECT_WARPS][32];
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int width = min(k, m);
  const float inf = __int_as_float(0x7f800000);
  const float* cv = cvals + static_cast<size_t>(row) * q;
  const int32_t* ci = cidx + static_cast<size_t>(row) * q;
  for (int p = threadIdx.x; p < q; p += SELECT_THREADS)
    skey[p] = order_key(cv[p]);
  __syncthreads();
  const int j0 = blockIdx.x * RANK_J;
  const int j = j0 + lane;
  const uint32_t kj = j < q ? skey[j] : 0xffffffffu;
  const int per = (q + SELECT_WARPS - 1) / SELECT_WARPS;
  const int lo = warp * per;
  const int hi = min(q, lo + per);
  int r = 0;
  // below this block's candidates a tie counts (i < j), above it does not
  for (int i = lo; i < min(hi, j0); ++i) r += skey[i] <= kj;
  for (int i = max(lo, j0); i < min(hi, j0 + RANK_J); ++i) {
    const uint32_t ki = skey[i];
    r += ki < kj || (ki == kj && i < j);
  }
  for (int i = max(lo, j0 + RANK_J); i < hi; ++i) r += skey[i] < kj;
  part[warp][lane] = r;
  __syncthreads();
  if (warp == 0 && j < q) {
    int rank = 0;
    for (int w = 0; w < SELECT_WARPS; ++w) rank += part[w][lane];
    if (rank < width) {
      vals[static_cast<size_t>(row) * width + rank] = cv[j];
      idx[static_cast<size_t>(row) * width + rank] = ci[j];
    }
    if (rank == k && m > k) tau[row] = cv[j];
  }
  if (blockIdx.x == 0) {
    for (int p = q + threadIdx.x; p < width; p += SELECT_THREADS) {
      vals[static_cast<size_t>(row) * width + p] = inf;
      idx[static_cast<size_t>(row) * width + p] = -1;
    }
    if (threadIdx.x == 0 && !(m > k && k < q)) tau[row] = inf;
  }
}

// cand_vals, cand_idx [nf, q]: each row's q candidates, in index order.
// With ranked != 0 (q <= RANK_Q_MAX) they are also sorted into vals, idx
// [nf, min(k, m)] and tau [nf]; else the caller sorts them.
extern "C" int repro_select(const void* seeds, void* cand_vals,
                            void* cand_idx, void* vals, void* idx, void* tau,
                            void* state, void* counts, void* scratch, int nf,
                            int n, int q, int m, int k, int blocks, int chunk,
                            int ranked, void* stream) {
  if (nf < 1 || n < 1 || q < 1 || q > n || m < q || k < 0 || blocks < 1 ||
      chunk < 1 || chunk % (32 * SELECT_WARPS) != 0 ||
      static_cast<long long>(blocks) * chunk < n ||
      (ranked && q > RANK_Q_MAX))
    return 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, nf);
  const float* in = static_cast<const float*>(seeds);
  uint32_t* st = static_cast<uint32_t*>(state);
  unsigned int* sc = static_cast<unsigned int*>(scratch);
  float* cv = static_cast<float*>(cand_vals);
  int32_t* ci = static_cast<int32_t*>(cand_idx);
  select_hist_kernel<0><<<grid, SELECT_THREADS, 0, s>>>(in, st, sc, n, q,
                                                         chunk);
  select_hist_kernel<1><<<grid, SELECT_THREADS, 0, s>>>(in, st, sc, n, q,
                                                         chunk);
  select_hist_kernel<2><<<grid, SELECT_THREADS, 0, s>>>(in, st, sc, n, q,
                                                         chunk);
  select_count_kernel<<<grid, SELECT_THREADS, 0, s>>>(
      in, st, static_cast<int*>(counts), sc, n, chunk);
  select_write_kernel<<<grid, SELECT_THREADS, 0, s>>>(
      in, st, static_cast<const int*>(counts), cv, ci, n, q, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !ranked) return static_cast<int>(err);
  const int smem = q * static_cast<int>(sizeof(uint32_t));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        select_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RANK_Q_MAX * static_cast<int>(sizeof(uint32_t)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_rank_kernel<<<dim3((q + RANK_J - 1) / RANK_J, nf), SELECT_THREADS,
                       smem, s>>>(cv, ci, static_cast<float*>(vals),
                                  static_cast<int32_t*>(idx),
                                  static_cast<float*>(tau), q, m, k);
  return static_cast<int>(cudaGetLastError());
}
