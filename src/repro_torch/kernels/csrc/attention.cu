// K7: attention forward and backward, fused, on bf16 q/k/v.
//
// Replaces no TPU kernel: the reference's attention
// (src/repro/models/layers.py `_make_flash`) is plain JAX under XLA, a loop
// of fp32 einsums over (q chunk, kv chunk) tiles with a custom_vjp that
// saves (out, lse) and recomputes the tiles in backward. It is added here
// because the port's eager copy of that loop (the plain version in
// kernels/attention.py) ran its tiles as fp32 products on CUDA cores and
// took most of a training step.
//
// Arithmetic: the reference's, with only the order of fp32 sums changed.
//   S = q k^T      bf16 operands, fp32 accumulation (the products of two
//                  bf16 values are exact in fp32, as in the fp32 einsum);
//   P V            P rounded to bf16 first, as the reference does;
//   dP = dO V^T    bf16 operands;
//   dV = P^T dO, dK = dS^T Q, dQ = dS K: the reference's P or dS operand
//                  is fp32. It is split into three bf16 parts
//                  hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid,
//                  which sum to x exactly (for |x| >= 2^-110), and each
//                  part is multiplied by the exact bf16 operand.
// The scale, the -1e30 mask value, the clamps (-0.5e30, 1e-30) and the
// zero output of a row that sees no key are the reference's.
//
// Bound on the H100: tensor-core operations. At granite-moe's shape
// (B 4, S 4,096, 16 q / 8 kv heads of 64) the forward is 2 causal
// S x S products, the backward 8 (S, dP, 3 x dV, 3 x dK) in the dK/dV pass
// and 5 (S, dP, 3 x dQ) in the dQ pass; the exps are a few percent of it.
//
// Design: mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix from
// shared tiles padded by 16 bytes a row (no bank conflicts), cp.async
// double buffering of the streamed tiles. A q tile is 64 rows of the
// flattened (position, group head) index of one (batch, kv head), so a
// block holds its GQA group's q heads beside the keys they share, for any
// group size. Tiles that the causal mask or kv_end hides entirely are
// skipped; the mask is applied only on tiles that cross it. The backward
// is deterministic, with no atomics: a pre-pass writes delta = rowsum(dO
// O), one block per kv tile accumulates dK and dV over the q tiles, and
// one block per q tile accumulates dQ over the kv tiles; each output
// element is written by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;     // rows of a q tile
constexpr int BN = 64;     // keys of a kv tile
constexpr int NT = 128;    // 4 warps, 16 rows (or keys) each
constexpr float NEG = -1e30f;
constexpr float FLOOR = -0.5e30f;
constexpr float TINY = 1e-30f;

struct Shape {
  int B, Sq, Sk, H, KH, G;
  int R;           // Sq * G rows of one (batch, kv head)
  int q_offset;    // the position of q's first row
  int kv_end;      // keys at or past it are masked (min(Sk, kv_valid_len))
  int causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the low and high bf16 of a packed pair, as floats (exact)
__device__ __forceinline__ float low_half(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float high_half(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// (x0, x1) -> three packed bf16 pairs whose sum is (x0, x1) exactly
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack(x0, x1);
  const float r0 = x0 - low_half(hi), r1 = x1 - high_half(hi);
  mid = pack(r0, r1);
  lo = pack(r0 - low_half(mid), r1 - high_half(mid));
}

// lane's address in a 16 x 16 A operand at (row0, col0) of a [.][SH] tile
template <int SH>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int row0,
                                              int col0, int lane) {
  return t + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SH + col0 +
         (lane >> 4) * 8;
}

// lane's address for two 16 x 8 B operands (n0 and n0 + 8) read from a
// [n][k] tile at (n0, k0) (non-transposed ldmatrix)
template <int SH>
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int n0, int k0,
                                               int lane) {
  return t + (n0 + (lane & 7) + (lane >> 4) * 8) * SH + k0 +
         ((lane >> 3) & 1) * 8;
}

// the same from a [k][n] tile at (k0, n0) (transposed ldmatrix)
template <int SH>
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int k0, int n0,
                                              int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SH + n0 +
         (lane >> 4) * 8;
}

// element offset / HD of row r (position r / G, head g = r % G of kv head
// kh) in a [B, Sq, H, HD] tensor
__device__ __forceinline__ size_t q_row(const Shape& s, int b, int kh,
                                        int r) {
  const int pos = r / s.G;
  return (static_cast<size_t>(b) * s.Sq + pos) * s.H + kh * s.G +
         (r - pos * s.G);
}

__device__ __forceinline__ size_t k_row(const Shape& s, int b, int kh,
                                        int key) {
  return (static_cast<size_t>(b) * s.Sk + key) * s.KH + kh;
}

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          const Shape& s, int b, int kh,
                                          int r0) {
  constexpr int CH = HD / 8, SH = HD + 8;
  for (int c = threadIdx.x; c < BM * CH; c += NT) {
    const int row = c / CH, col = (c % CH) * 8, r = r0 + row;
    const bool ok = r < s.R;
    cp_async16(dst + row * SH + col,
               ok ? src + q_row(s, b, kh, r) * HD + col : src, ok);
  }
}

// keys at or past kv_end load as zeros (they are masked out)
template <int HD>
__device__ __forceinline__ void load_keys(bf16* dst, const bf16* src,
                                          const Shape& s, int b, int kh,
                                          int k0) {
  constexpr int CH = HD / 8, SH = HD + 8;
  for (int c = threadIdx.x; c < BN * CH; c += NT) {
    const int row = c / CH, col = (c % CH) * 8, key = k0 + row;
    const bool ok = key < s.kv_end;
    cp_async16(dst + row * SH + col,
               ok ? src + k_row(s, b, kh, key) * HD + col : src, ok);
  }
}

// acc[n-tile][.] += A(16 rows of `a` at row0) x B^T(64 rows of `bt`):
// a 16 x 64 product over the head dim, B read as [n][k]
template <int HD>
__device__ __forceinline__ void rows_by_keys(float (&acc)[8][4],
                                             const bf16* a, int row0,
                                             const bf16* bt, int lane) {
  constexpr int SH = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm4(af, a_addr<SH>(a, row0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm4(bf, bt_addr<SH>(bt, np * 16, kk * 16, lane));
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[hd-tile][.] += X(16 x 64, in C fragments) x T(64 x HD, [k][n] tile),
// X split into three exact bf16 parts
template <int HD>
__device__ __forceinline__ void split_times(float (&out)[HD / 8][4],
                                            const float (&x)[8][4],
                                            const bf16* t, int lane) {
  constexpr int SH = HD + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t h[4], m[4], l[4];
    split3(x[2 * kk][0], x[2 * kk][1], h[0], m[0], l[0]);
    split3(x[2 * kk][2], x[2 * kk][3], h[1], m[1], l[1]);
    split3(x[2 * kk + 1][0], x[2 * kk + 1][1], h[2], m[2], l[2]);
    split3(x[2 * kk + 1][2], x[2 * kk + 1][3], h[3], m[3], l[3]);
#pragma unroll
    for (int nd = 0; nd < HD / 16; ++nd) {
      uint32_t bf[4];
      ldsm4t(bf, b_addr<SH>(t, kk * 16, nd * 16, lane));
      mma(out[2 * nd], h, bf[0], bf[1]);
      mma(out[2 * nd], m, bf[0], bf[1]);
      mma(out[2 * nd], l, bf[0], bf[1]);
      mma(out[2 * nd + 1], h, bf[2], bf[3]);
      mma(out[2 * nd + 1], m, bf[2], bf[3]);
      mma(out[2 * nd + 1], l, bf[2], bf[3]);
    }
  }
}

// the kv tiles a q tile of rows [r0, r0 + BM) sees: keys below kv_hi
__device__ __forceinline__ int kv_tiles(const Shape& s, int r0) {
  const int last = min(r0 + BM, s.R) - 1;
  int kv_hi = s.kv_end;
  if (s.causal) kv_hi = min(kv_hi, s.q_offset + last / s.G + 1);
  return kv_hi > 0 ? (kv_hi + BN - 1) / BN : 0;
}

// true when some score of the (q tile at r0, kv tile at key0) pair is
// masked
__device__ __forceinline__ bool crosses_mask(const Shape& s, int r0,
                                             int key0) {
  return r0 + BM > s.R || key0 + BN > s.kv_end ||
         (s.causal && key0 + BN - 1 > s.q_offset + r0 / s.G);
}

__device__ __forceinline__ bool visible(const Shape& s, int r, int key) {
  return r < s.R && key < s.kv_end &&
         (!s.causal || key <= s.q_offset + r / s.G);
}

template <int HD>
__global__ void __launch_bounds__(NT)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Shape s) {
  constexpr int SH = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * SH;        // two buffers of BN x SH
  bf16* sV = sK + 2 * BN * SH;    // two buffers of BN x SH
  const int r0 = blockIdx.x * BM, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ntiles = kv_tiles(s, r0);
  int rows[2];
  rows[0] = r0 + warp * 16 + g8;
  rows[1] = rows[0] + 8;

  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;

  load_rows<HD>(sQ, q, s, b, kh, r0);
  if (ntiles > 0) {
    load_keys<HD>(sK, k, s, b, kh, 0);
    load_keys<HD>(sV, v, s, b, kh, 0);
  }
  cp_commit();
  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {
      load_keys<HD>(sK + (cur ^ 1) * BN * SH, k, s, b, kh, (j + 1) * BN);
      load_keys<HD>(sV + (cur ^ 1) * BN * SH, v, s, b, kh, (j + 1) * BN);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sK + cur * BN * SH;
    const bf16* vt = sV + cur * BN * SH;
    const int key0 = j * BN;

    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
    rows_by_keys<HD>(sc, sQ, warp * 16, kt, lane);

    const bool masked = crosses_mask(s, r0, key0);
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * s.scale;
        if (masked && !visible(s, rows[e >> 1], key0 + nt * 8 + 2 * t4 +
                                                     (e & 1)))
          x = NEG;
        sc[nt][e] = x;
        mn[e >> 1] = fmaxf(mn[e >> 1], x);
      }
    float msafe[2], corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = fmaxf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], 1));
      mn[i] = fmaxf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], 2));
      msafe[i] = fmaxf(mn[i], FLOOR);
      corr[i] = expf(fmaxf(m[i], FLOOR) - msafe[i]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - msafe[e >> 1]);
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
      m[i] = mn[i];
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
    // acc += bf16(P) V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t bf[4];
        ldsm4t(bf, b_addr<SH>(vt, kk * 16, nd * 16, lane));
        mma(acc[2 * nd], a, bf[0], bf[1]);
        mma(acc[2 * nd + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= s.R) continue;
    const float lc = fmaxf(l[i], TINY);
    bf16* orow = o + q_row(s, b, kh, rows[i]) * HD + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack(acc[nd][2 * i] / lc, acc[nd][2 * i + 1] / lc);
    if (t4 == 0)
      lse[(static_cast<size_t>(b) * s.KH + kh) * s.R + rows[i]] =
          fmaxf(m[i], FLOOR) + logf(lc);
  }
}

// delta = rowsum(dO * O) in fp32, one warp per row of [B, Sq, H, HD],
// written in the kernel's [B, KH, R] row layout
template <int HD>
__global__ void __launch_bounds__(256)
    attn_delta_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      float* __restrict__ delta, Shape s) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(s.B) * s.Sq * s.H) return;
  const bf16* orow = o + row * HD;
  const bf16* drow = dout + row * HD;
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    acc += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % s.H);
    const size_t bs = row / s.H;
    const int pos = static_cast<int>(bs % s.Sq);
    const int b = static_cast<int>(bs / s.Sq);
    const int kh = h / s.G;
    delta[(static_cast<size_t>(b) * s.KH + kh) * s.R + pos * s.G +
          (h - kh * s.G)] = acc;
  }
}

// dK, dV of one kv tile: its loop runs over the q tiles (every position
// and group head) that see the tile
// three blocks an SM at head dim 64 (at most 168 registers, no spill);
// the wider ones hold two
template <int HD>
__global__ void __launch_bounds__(NT, HD == 64 ? 3 : 1)
    attn_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Shape s) {
  constexpr int SH = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * SH;
  bf16* sQ = sV + BN * SH;         // two buffers of BM x SH
  bf16* sO = sQ + 2 * BM * SH;     // dO, two buffers of BM x SH
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * SH);   // [2][BM]
  float* sD = sL + 2 * BM;                                  // [2][BM]
  const int k0 = blockIdx.x * BN, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t rowbase = (static_cast<size_t>(b) * s.KH + kh) * s.R;

  // q tiles with a row that can see key k0 or later
  int first = 0;
  if (s.causal) first = max(k0 - s.q_offset, 0) * s.G / BM;
  const int end = k0 < s.kv_end ? (s.R + BM - 1) / BM : 0;

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.0f;

  auto load_tile = [&](int it, int buf) {
    const int r0 = it * BM;
    load_rows<HD>(sQ + buf * BM * SH, q, s, b, kh, r0);
    load_rows<HD>(sO + buf * BM * SH, dout, s, b, kh, r0);
    if (threadIdx.x < BM) {
      const int r = r0 + threadIdx.x;
      sL[buf * BM + threadIdx.x] = r < s.R ? lse[rowbase + r] : 0.0f;
      sD[buf * BM + threadIdx.x] = r < s.R ? delta[rowbase + r] : 0.0f;
    }
  };

  if (first < end) {
    load_keys<HD>(sK, k, s, b, kh, k0);
    load_keys<HD>(sV, v, s, b, kh, k0);
    load_tile(first, 0);
  }
  cp_commit();
  for (int it = first; it < end; ++it) {
    const int cur = (it - first) & 1;
    if (it + 1 < end) {
      load_tile(it + 1, cur ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* qt = sQ + cur * BM * SH;
    const bf16* ot = sO + cur * BM * SH;
    const float* lt = sL + cur * BM;
    const float* dt = sD + cur * BM;
    const int r0 = it * BM;

    // S^T and dP^T: this warp's 16 keys x the tile's 64 rows
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
    rows_by_keys<HD>(st, sK, warp * 16, qt, lane);
    rows_by_keys<HD>(dpt, sV, warp * 16, ot, lane);

    const bool masked = crosses_mask(s, r0, k0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 lv = *reinterpret_cast<const float2*>(lt + nt * 8 + 2 * t4);
      const float2 dv = *reinterpret_cast<const float2*>(dt + nt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = nt * 8 + 2 * t4 + (e & 1);
        float x = st[nt][e] * s.scale;
        if (masked &&
            !visible(s, r0 + rl, k0 + warp * 16 + g8 + 8 * (e >> 1)))
          x = NEG;
        const float p = expf(x - ((e & 1) ? lv.y : lv.x));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dv.y : dv.x)) * s.scale;
      }
    }
    split_times<HD>(dva, st, ot, lane);     // dV += P^T dO
    split_times<HD>(dka, dpt, qt, lane);    // dK += dS^T Q
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g8 + 8 * i;
    if (key >= s.Sk) continue;
    const size_t off = k_row(s, b, kh, key) * HD + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dk + off + nd * 8) =
          pack(dka[nd][2 * i], dka[nd][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + nd * 8) =
          pack(dva[nd][2 * i], dva[nd][2 * i + 1]);
    }
  }
}

// dQ of one q tile: its loop runs over the kv tiles it sees
template <int HD>
__global__ void __launch_bounds__(NT)
    attn_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   Shape s) {
  constexpr int SH = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BM * SH;
  bf16* sK = sO + BM * SH;        // two buffers of BN x SH
  bf16* sV = sK + 2 * BN * SH;    // two buffers of BN x SH
  const int r0 = blockIdx.x * BM, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ntiles = kv_tiles(s, r0);
  const size_t rowbase = (static_cast<size_t>(b) * s.KH + kh) * s.R;
  int rows[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = r0 + warp * 16 + g8 + 8 * i;
    lr[i] = rows[i] < s.R ? lse[rowbase + rows[i]] : 0.0f;
    dr[i] = rows[i] < s.R ? delta[rowbase + rows[i]] : 0.0f;
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
    dqa[nd][0] = dqa[nd][1] = dqa[nd][2] = dqa[nd][3] = 0.0f;

  load_rows<HD>(sQ, q, s, b, kh, r0);
  load_rows<HD>(sO, dout, s, b, kh, r0);
  if (ntiles > 0) {
    load_keys<HD>(sK, k, s, b, kh, 0);
    load_keys<HD>(sV, v, s, b, kh, 0);
  }
  cp_commit();
  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {
      load_keys<HD>(sK + (cur ^ 1) * BN * SH, k, s, b, kh, (j + 1) * BN);
      load_keys<HD>(sV + (cur ^ 1) * BN * SH, v, s, b, kh, (j + 1) * BN);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sK + cur * BN * SH;
    const bf16* vt = sV + cur * BN * SH;
    const int key0 = j * BN;

    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.0f;
    rows_by_keys<HD>(sc, sQ, warp * 16, kt, lane);
    rows_by_keys<HD>(dp, sO, warp * 16, vt, lane);

    const bool masked = crosses_mask(s, r0, key0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = sc[nt][e] * s.scale;
        if (masked && !visible(s, rows[i], key0 + nt * 8 + 2 * t4 + (e & 1)))
          x = NEG;
        const float p = expf(x - lr[i]);
        dp[nt][e] = p * (dp[nt][e] - dr[i]) * s.scale;
      }
    split_times<HD>(dqa, dp, kt, lane);     // dQ += dS K
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= s.R) continue;
    bf16* qrow = dq + q_row(s, b, kh, rows[i]) * HD + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<uint32_t*>(qrow + nd * 8) =
          pack(dqa[nd][2 * i], dqa[nd][2 * i + 1]);
  }
}

Shape make_shape(int B, int Sq, int Sk, int H, int KH, int q_offset,
                 int kv_end, int causal, float scale) {
  Shape s;
  s.B = B;
  s.Sq = Sq;
  s.Sk = Sk;
  s.H = H;
  s.KH = KH;
  s.G = H / KH;
  s.R = Sq * s.G;
  s.q_offset = q_offset;
  s.kv_end = kv_end < Sk ? kv_end : Sk;
  s.causal = causal;
  s.scale = scale;
  return s;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t tile_bytes(int hd, int rows) {
  return static_cast<size_t>(rows) * (hd + 8) * sizeof(bf16);
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const Shape& s, cudaStream_t stream) {
  const size_t smem = tile_bytes(HD, BM + 4 * BN);
  cudaError_t err = set_smem(attn_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.R + BM - 1) / BM, s.KH, s.B);
  attn_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* delta, void* dq, void* dk, void* dv,
                       const Shape& s, cudaStream_t stream) {
  const bf16 *qp = static_cast<const bf16*>(q),
             *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v),
             *dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const size_t rows = static_cast<size_t>(s.B) * s.Sq * s.H;
  attn_delta_kernel<HD><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                          stream>>>(static_cast<const bf16*>(o), dop, dp, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = tile_bytes(HD, 2 * BN + 4 * BM) +
                         4 * BM * sizeof(float);
  if ((err = set_smem(attn_dkdv_kernel<HD>, smem_kv)) != cudaSuccess)
    return err;
  const dim3 grid_kv((s.Sk + BN - 1) / BN, s.KH, s.B);
  attn_dkdv_kernel<HD><<<grid_kv, NT, smem_kv, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = tile_bytes(HD, 2 * BM + 4 * BN);
  if ((err = set_smem(attn_dq_kernel<HD>, smem_q)) != cudaSuccess) return err;
  const dim3 grid_q((s.R + BM - 1) / BM, s.KH, s.B);
  attn_dq_kernel<HD><<<grid_q, NT, smem_q, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), s);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, hd], k/v [B, Sk, KH, hd] bf16 (hd 64, 128 or 256) ->
// o [B, Sq, H, hd] bf16, lse [B, KH, Sq * H / KH] fp32
extern "C" int repro_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk,
                              int H, int KH, int hd, int q_offset,
                              int kv_end, int causal, float scale,
                              void* stream) {
  const Shape s = make_shape(B, Sq, Sk, H, KH, q_offset, kv_end, causal,
                             scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return static_cast<int>(launch_fwd<64>(q, k, v, o, lse, s, st));
    case 128:
      return static_cast<int>(launch_fwd<128>(q, k, v, o, lse, s, st));
    case 256:
      return static_cast<int>(launch_fwd<256>(q, k, v, o, lse, s, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the forward's inputs and outputs, dO, and a scratch delta shaped as lse
// -> dq, dk, dv (shaped as q, k, v)
extern "C" int repro_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int Sq, int Sk,
                              int H, int KH, int hd, int q_offset,
                              int kv_end, int causal, float scale,
                              void* stream) {
  const Shape s = make_shape(B, Sq, Sk, H, KH, q_offset, kv_end, causal,
                             scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return static_cast<int>(launch_bwd<64>(q, k, v, o, dout, lse, delta, dq,
                                             dk, dv, s, st));
    case 128:
      return static_cast<int>(launch_bwd<128>(q, k, v, o, dout, lse, delta,
                                              dq, dk, dv, s, st));
    case 256:
      return static_cast<int>(launch_bwd<256>(q, k, v, o, dout, lse, delta,
                                              dq, dk, dv, s, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
