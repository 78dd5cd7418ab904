// K2: block-local bottom-k over every objective row of a [F, n] seed matrix.
//
// Replaces the TPU kernel src/repro/kernels/blockselect.py
// `_blockselect_kernel` (pallas_call in `batched_block_bottomk`): per row and
// per span of <= 2048 slots, the k smallest seeds in ascending order, ties
// lowest index first, invalid (+inf) entries reported as (+inf, -1). The
// second stage (one selection over the candidates) stays with the caller.
//
// Bound on the H100: bytes. Each seed is read once (4 bytes) and each
// candidate written once (8 bytes: value and index). The TPU kernel ran k
// vector min-and-mask rounds per block, O(k * span) work that suits the VPU
// but not a GPU. Here one thread block (1024 threads) loads its span into
// shared memory (2048 (value, index) pairs, 16 KB) and bitonic-sorts it by
// (value, index) in 66 compare-exchange stages, then writes the first
// kb = min(k, span) pairs. The (value, index) key reproduces the
// lowest-index-first tie order exactly, whatever k is.
#include "common.cuh"

#define SPAN_MAX 2048
#define SORT_THREADS 1024

__device__ __forceinline__ bool pair_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(SORT_THREADS)
blockselect_kernel(const float* __restrict__ seeds, float* __restrict__ vals,
                   int32_t* __restrict__ idx, int n, int span, int kb,
                   int nb) {
  __shared__ float sv[SPAN_MAX];
  __shared__ int si[SPAN_MAX];
  const float inf = __int_as_float(0x7f800000);
  const int blk = blockIdx.x;
  const int row = blockIdx.y;
  const int base = blk * span;
  const float* src = seeds + static_cast<size_t>(row) * n;
  for (int t = threadIdx.x; t < SPAN_MAX; t += SORT_THREADS) {
    const int pos = base + t;
    const bool in = t < span && pos < n;
    sv[t] = in ? src[pos] : inf;
    si[t] = in ? pos : 0x7fffffff;
  }
  for (int size = 2; size <= SPAN_MAX; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int t = threadIdx.x;
      const int i = 2 * t - (t & (stride - 1));
      const int j = i + stride;
      const bool ascending = (i & size) == 0;
      const float vi = sv[i], vj = sv[j];
      const int ii = si[i], ij = si[j];
      if (pair_less(vj, ij, vi, ii) == ascending) {
        sv[i] = vj; sv[j] = vi;
        si[i] = ij; si[j] = ii;
      }
    }
  }
  __syncthreads();
  const size_t out = static_cast<size_t>(row) * nb * kb +
                     static_cast<size_t>(blk) * kb;
  for (int t = threadIdx.x; t < kb; t += SORT_THREADS) {
    const float v = sv[t];
    vals[out + t] = v;
    idx[out + t] = v < inf ? si[t] : -1;
  }
}

extern "C" int repro_blockselect(const void* seeds, void* vals, void* idx,
                                 int nf, int n, int span, int kb,
                                 void* stream) {
  if (span < 1 || span > SPAN_MAX || kb < 1 || kb > span) return 1;
  const int nb = (n + span - 1) / span;
  const dim3 grid(nb, nf);
  blockselect_kernel<<<grid, SORT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seeds), static_cast<float*>(vals),
      static_cast<int32_t*>(idx), n, span, kb, nb);
  return static_cast<int>(cudaGetLastError());
}
