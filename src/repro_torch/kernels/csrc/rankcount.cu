// K6: rank counts for universal sample membership, as an O(n log n)
// dominance count.
//
// Replaces the TPU kernel src/repro/kernels/rankcount.py `_rankcount_kernel`
// (pallas_call in `rank_counts`), which compares all pairs of keys:
//   h_x = #{y : w_y >= w_x  and  s_h,y < s_h,x}     (monotone, Lemma 5.1)
//   l_x = #{y : w_y <  w_x  and  s_l,y < s_l,x}     (capping, Lemma 6.3)
// over the pairs where x and y are both active. At n = 2^20 that is 1e12
// pairs. Both counts are 2-D dominance counts: the wrapper
// (kernels/rankcount.py `rank_counts_by_order`) orders the keys so that y
// can count for x only if it comes before x (h: w descending, s_h
// ascending; l: w ascending, s_l descending), and then each count is the
// number of EARLIER elements of that order with a strictly smaller s. This
// file computes those counts for the two orders, as two rows of the same
// launches, by a merge sort on s:
//   1. one block per run of RUN = 2048 elements sorts its run in shared
//      memory (11 merge steps) and gives each element its count of smaller
//      earlier elements inside the run;
//   2. each global merge level (about 9 at 2^20) merges pairs of runs by
//      merge path: a block takes TILE outputs, finds its split of the left
//      and right run by a binary search, stages both pieces in shared memory
//      and places each element by a binary search in the other piece. A
//      right-run element adds the number of left-run elements strictly
//      below it: i0 (the left elements before its piece, all smaller) plus
//      its lower bound in the left piece. Equal values merge right first,
//      so that number is also its place among the left elements;
//   3. the last step writes each count to the key's own position, carried
//      through the merges.
// Comparisons are float `<`, never raw bits; the wrapper gives keys that
// take no part (inactive, NaN) s = +inf and puts them last, and zeroes them.
// Counts are integer sums (no atomics): exact, the same on every run.
//
// Bound on the H100: bytes. The keys' weight, seeds and activity are read
// once and h, l written once (~21 MB at 2^20, 0.006 ms at 3.35 TB/s); the
// n log2 n comparisons (4.2e7 for both rows) are far below the fp32 rate.
// The merge levels move 12 bytes per element and level through L2.
#include "common.cuh"

#define RUN 2048
#define RUN_THREADS 1024
#define TILE 2048
#define MERGE_THREADS 512

// # of a[0..len) strictly below v (a ascending)
__device__ __forceinline__ int count_below(const float* a, int len, float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// # of a[0..len) at or below v (a ascending)
__device__ __forceinline__ int count_not_above(const float* a, int len,
                                               float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(v < a[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// step 1: sort each run of RUN elements by s, counting within the run
__global__ void __launch_bounds__(RUN_THREADS)
rank_run_kernel(const float* __restrict__ s_in,
                const int32_t* __restrict__ p_in, float* __restrict__ s_out,
                int32_t* __restrict__ c_out, int32_t* __restrict__ p_out,
                int32_t* __restrict__ out, int m) {
  __shared__ float sv[2][RUN];
  __shared__ int32_t sc[2][RUN];
  __shared__ int32_t sp[2][RUN];
  const size_t row = static_cast<size_t>(blockIdx.y) * m;
  const int base = blockIdx.x * RUN;
  const int len = min(RUN, m - base);
  for (int e = threadIdx.x; e < len; e += RUN_THREADS) {
    sv[0][e] = s_in[row + base + e];
    sc[0][e] = 0;
    sp[0][e] = p_in[row + base + e];
  }
  int cur = 0;
  for (int r = 1; r < len; r <<= 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < len; e += RUN_THREADS) {
      const int a = e & ~(2 * r - 1);                 // this pair's start
      const int nl = min(r, len - a);
      const int nr = max(0, min(r, len - a - r));
      const float v = sv[cur][e];
      int c = sc[cur][e];
      int o;
      if (e - a < r) {                                 // left run
        o = e + count_not_above(&sv[cur][a + r], nr, v);
      } else {                                         // right run
        const int below = count_below(&sv[cur][a], nl, v);
        o = e - r + below;
        c += below;
      }
      sv[cur ^ 1][o] = v;
      sc[cur ^ 1][o] = c;
      sp[cur ^ 1][o] = sp[cur][e];
    }
    cur ^= 1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < len; e += RUN_THREADS) {
    if (out) {
      out[row + sp[cur][e]] = sc[cur][e];
    } else {
      s_out[row + base + e] = sv[cur][e];
      c_out[row + base + e] = sc[cur][e];
      p_out[row + base + e] = sp[cur][e];
    }
  }
}

// # of the left run among the first d outputs of the merge (equal values:
// right first)
__device__ int merge_split(const float* l, int nl, const float* r, int nr,
                           int d) {
  int lo = max(0, d - nr), hi = min(d, nl);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (l[mid] < r[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// step 2: one merge level of runs of `run` elements
__global__ void __launch_bounds__(MERGE_THREADS)
rank_merge_kernel(const float* __restrict__ s_in,
                  const int32_t* __restrict__ c_in,
                  const int32_t* __restrict__ p_in, float* __restrict__ s_out,
                  int32_t* __restrict__ c_out, int32_t* __restrict__ p_out,
                  int32_t* __restrict__ out, int m, long long run) {
  __shared__ float ss[TILE];
  __shared__ int32_t sc[TILE];
  __shared__ int32_t sp[TILE];
  __shared__ int split[2];
  const size_t row = static_cast<size_t>(blockIdx.y) * m;
  const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long base = t0 / (2 * run) * (2 * run);
  const int nl = static_cast<int>(min(run, m - base));
  const int nr = static_cast<int>(max(0LL, min(run, m - base - run)));
  const int d0 = static_cast<int>(t0 - base);
  const int d1 = min(d0 + TILE, nl + nr);
  const float* left = s_in + row + base;
  const float* right = left + nl;
  if (threadIdx.x < 2) {
    split[threadIdx.x] =
        merge_split(left, nl, right, nr, threadIdx.x ? d1 : d0);
  }
  __syncthreads();
  const int i0 = split[0], i1 = split[1];
  const int j0 = d0 - i0, j1 = d1 - i1;
  const int la = i1 - i0, lb = j1 - j0;
  for (int e = threadIdx.x; e < la + lb; e += MERGE_THREADS) {
    const size_t g = row + base + (e < la ? i0 + e : nl + j0 + (e - la));
    ss[e] = s_in[g];
    sc[e] = c_in[g];
    sp[e] = p_in[g];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < la + lb; e += MERGE_THREADS) {
    const float v = ss[e];
    int c = sc[e];
    int o;
    if (e < la) {
      o = e + count_not_above(ss + la, lb, v);
    } else {
      const int below = count_below(ss, la, v);
      o = e - la + below;
      c += i0 + below;
    }
    if (out) {
      out[row + sp[e]] = c;
    } else {
      const size_t g = row + base + d0 + o;
      s_out[g] = v;
      c_out[g] = c;
      p_out[g] = sp[e];
    }
  }
}

// s [2, n] in each row's order, pos [2, n] the keys' positions in that
// order; out [2, n] receives each key's count at its position. scratch:
// two buffers of (s, count, pos) x [2, n], 24 * n int32 words.
extern "C" int repro_rankcount(const void* s, const void* pos, void* out,
                               void* scratch, int n, void* stream) {
  if (n < 1) return 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t plane = 2 * static_cast<size_t>(n);
  float* s_buf[2];
  int32_t* c_buf[2];
  int32_t* p_buf[2];
  for (int b = 0; b < 2; ++b) {
    int32_t* base = static_cast<int32_t*>(scratch) + 3 * plane * b;
    s_buf[b] = reinterpret_cast<float*>(base);
    c_buf[b] = base + plane;
    p_buf[b] = base + 2 * plane;
  }
  int32_t* res = static_cast<int32_t*>(out);
  const bool one_run = n <= RUN;
  rank_run_kernel<<<dim3((n + RUN - 1) / RUN, 2), RUN_THREADS, 0, st>>>(
      static_cast<const float*>(s), static_cast<const int32_t*>(pos),
      s_buf[0], c_buf[0], p_buf[0], one_run ? res : nullptr, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one_run) return static_cast<int>(err);
  int cur = 0;
  for (long long run = RUN; run < n; run *= 2) {
    const bool last = 2 * run >= n;
    rank_merge_kernel<<<dim3((n + TILE - 1) / TILE, 2), MERGE_THREADS, 0,
                        st>>>(
        s_buf[cur], c_buf[cur], p_buf[cur], s_buf[cur ^ 1], c_buf[cur ^ 1],
        p_buf[cur ^ 1], last ? res : nullptr, n, run);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur ^= 1;
  }
  return 0;
}
