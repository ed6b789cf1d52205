// Non-causal multi-head attention on the packed (B, N, H*D) layout, forward
// (out, lse) and backward (dq, dk, dv): the attention of every transformer of
// the zoo (ViT/MAE, BiT-CD, ChangeFormer, TransUNet-CD).
//
// Replaces the TPU kernels kurosiwo_tpu/ops/pallas_attention.py::
// _short_fwd_kernel (:259, launched by _short_fwd_local, :332) and
// _short_bwd_kernel (:283, launched by _short_bwd_local, :392). As there,
// delta = sum_d(do * out) is computed by the caller, in plain PyTorch.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes. At the
// MAE ViT-L batch-64 shapes (H 16, D 64, bf16) a decoder layer (N 196) must
// move q, k, v, out and lse, 103.6 MB, in 30.9 us forward, and q, k, v, do,
// lse, delta, dq, dk, dv, 181.4 MB, in 54.1 us backward; an encoder layer
// (N 49) 25.9 MB (7.7 us) and 45.4 MB (13.5 us). Its products, 10.1 GFLOP
// forward and 25.2 backward per decoder layer, need 10.2 and 25.4 us at the
// bf16 tensor-core rate. All 64 calls of a train step: 1.19 ms.
//
// Design. The TPU kernel holds one batch element's whole (N, H*D) rows in
// VMEM and loops the heads; the card wants many small blocks instead:
//  * the packed layout is read and written in place: every tensor comes with
//    its own batch and row strides (in elements), so q, k and v may be the
//    three column-thirds of the qkv projection with no copy, and no head
//    transpose is ever made in device memory;
//  * forward: one block per (query tile of 64 rows, batch x head). K/V tiles
//    of 64 rows stream through shared memory with an online softmax (running
//    max and sum in f32); out = acc / l, lse = m + log l. Any N and Nk work
//    (49 to 3136 on the zoo's paths), with no (N, N) tile;
//  * backward, deterministic with no float atomics: one block per (key tile,
//    batch x head) accumulates dk and dv over the query tiles, one block per
//    (query tile, batch x head) accumulates dq over the key tiles; both
//    recompute p = exp(s - lse). As in the TPU kernel, p and ds are rounded
//    to the input type before their products;
//  * bf16 (the training path): tensor-core products, mma.sync m16n8k16 with
//    f32 accumulators, 4 warps of 16 rows each per block. Scores stay in
//    registers: their accumulator fragments are re-packed as the A operand
//    of the next product (P V, P^T dO, dS^T Q, dS K); the operands needed
//    transposed (V, dO, Q, K as k x n) come from the row-major tiles through
//    ldmatrix.trans, so no tile is ever transposed in memory. Tiles are
//    bf16 in shared memory with rows padded by 8 elements (conflict-free
//    fragment loads);
//  * f32 (the parity path): f32 FMA on f32 tiles in shared memory, a 4x4
//    register tile of the 64x64 scores per thread of 256, rows padded by one
//    float. Bound by the FMA rate (67 TFLOP/s on CUDA cores), not by bytes.
//  Neither version pipelines its loads (each tile is loaded, then used, with
//  a barrier between): the products wait for memory, so both stay well above
//  the bytes bound; TMA + wgmma with a ring of tiles is the next step
//  (ROADMAP B4).
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows of a query or key tile

template <typename T>
struct View {  // element (b, n, col) at p[b * sb + n * sn + col]
  T* p;
  long long sb, sn;
};

__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// lse and delta of query rows [q0, q0 + 64) into shared memory (0 past nq)
__device__ __forceinline__ void load_row_stats(float* ls, float* dl, const float* lse,
                                               const float* delta, int bh, int q0, int nq) {
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    const int row = q0 + r;
    const long long i = static_cast<long long>(bh) * nq + row;
    ls[r] = row < nq ? lse[i] : 0.f;
    dl[r] = row < nq ? delta[i] : 0.f;
  }
}

// ===================================================================== f32

namespace simt {

constexpr int kThreads = 256;  // 16 x 16: ty picks rows ty + 16 r, tx columns tx + 16 c
constexpr int kLdS = kTile + 1;

// rows [r0, r0 + 64) of head h of a packed tensor into a [64][D + 1] tile;
// rows at or past n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, View<const float> src, int b, int h, int r0,
                                          int n) {
  const float* base = src.p + b * src.sb + static_cast<long long>(h) * D;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? base[row * src.sn + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(View<float> dst, int b, int h, int r0, int n,
                                           const float (&acc)[4][D / 16], const float (&div)[4]) {
  float* base = dst.p + b * dst.sb + static_cast<long long>(h) * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) base[row * dst.sn + tx + 16 * c] = acc[r][c] / div[r];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[r][c] = sum_d a[(ty + 16 r)][d] * b[(tx + 16 c)][d] over [64][D + 1] tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, float (&s)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
  }
}

// acc[r][c] += sum_j p[(ty + 16 r)][j] * x[j][(tx + 16 c)], p a [64][65] tile
// and x a [64][D + 1] tile
template <int D>
__device__ __forceinline__ void tile_accumulate(const float* p, const float* x,
                                                float (&acc)[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float pv[4], xv[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[(ty + 16 * r) * kLdS + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(pv[r], xv[c], acc[r][c]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd(View<const float> q, View<const float> k, View<const float> v, View<float> o,
         float* __restrict__ lse, int heads, int nq, int nk, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* kts = qs + kTile * (D + 1);
  float* vs = kts + kTile * (D + 1);
  float* ps = vs + kTile * (D + 1);
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(qs, q, b, h, q0, nq);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;
  }
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(kts, k, b, h, k0, nk);
    load_tile<D>(vs, v, b, h, k0, nk);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(qs, kts, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = k0 + tx + 16 * c < nk ? scale * s[r][c] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      // every tile holds a valid column, so m_new is finite
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
        ps[(ty + 16 * r) * kLdS + tx + 16 * c] = s[r][c];
      }
      l[r] = l[r] * alpha + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    tile_accumulate<D>(ps, vs, acc);  // masked keys have p = 0 and v = 0
  }
  store_rows<D>(o, b, h, q0, nq, acc, l);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
      if (row < nq) lse[static_cast<long long>(bh) * nq + row] = m[r] + logf(l[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(View<const float> q, View<const float> k, View<const float> v,
              View<const float> dout, const float* __restrict__ lse,
              const float* __restrict__ delta, View<float> dk, View<float> dv, int heads, int nq,
              int nk, float scale) {
  extern __shared__ float smem[];
  float* kts = smem;
  float* vs = kts + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* pt = dos + kTile * (D + 1);  // [key j][query i]
  float* dst = pt + kTile * kLdS;
  float* ls = dst + kTile * kLdS;
  float* dl = ls + kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(kts, k, b, h, k0, nk);
  load_tile<D>(vs, v, b, h, k0, nk);
  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[r][c] = dva[r][c] = 0.f;
  for (int q0 = 0; q0 < nq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, q, b, h, q0, nq);
    load_tile<D>(dos, dout, b, h, q0, nq);
    load_row_stats(ls, dl, lse, delta, bh, q0, nq);
    __syncthreads();
    // rows: keys ty + 16 r; columns: queries tx + 16 c
    float st[4][4], dpt[4][4];
    tile_dot<D>(kts, qs, st);
    tile_dot<D>(vs, dos, dpt);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool key_in = k0 + ty + 16 * r < nk;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c;
        const float p = key_in && q0 + i < nq ? expf(scale * st[r][c] - ls[i]) : 0.f;
        pt[(ty + 16 * r) * kLdS + i] = p;
        dst[(ty + 16 * r) * kLdS + i] = p * (dpt[r][c] - dl[i]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate<D>(pt, dos, dva);
    tile_accumulate<D>(dst, qs, dka);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk, b, h, k0, nk, dka, one);
  store_rows<D>(dv, b, h, k0, nk, dva, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(View<const float> q, View<const float> k, View<const float> v,
            View<const float> dout, const float* __restrict__ lse,
            const float* __restrict__ delta, View<float> dq, int heads, int nq, int nk,
            float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 1);
  float* kts = dos + kTile * (D + 1);
  float* vs = kts + kTile * (D + 1);
  float* dss = vs + kTile * (D + 1);  // [query i][key j]
  float* ls = dss + kTile * kLdS;
  float* dl = ls + kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(qs, q, b, h, q0, nq);
  load_tile<D>(dos, dout, b, h, q0, nq);
  load_row_stats(ls, dl, lse, delta, bh, q0, nq);
  float dqa[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[r][c] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_tile<D>(kts, k, b, h, k0, nk);
    load_tile<D>(vs, v, b, h, k0, nk);
    __syncthreads();
    // rows: queries ty + 16 r; columns: keys tx + 16 c
    float s[4][4], dp[4][4];
    tile_dot<D>(qs, kts, s);
    tile_dot<D>(dos, vs, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const bool query_in = q0 + i < nq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float p = query_in && k0 + j < nk ? expf(scale * s[r][c] - ls[i]) : 0.f;
        dss[i * kLdS + j] = p * (dp[r][c] - dl[i]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate<D>(dss, kts, dqa);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dq, b, h, q0, nq, dqa, one);
}

constexpr size_t tile_bytes(int d) { return sizeof(float) * kTile * (d + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kLdS; }
constexpr size_t fwd_smem(int d) { return 3 * tile_bytes(d) + score_bytes(); }
constexpr size_t dkdv_smem(int d) {
  return 4 * tile_bytes(d) + 2 * score_bytes() + 2 * kTile * sizeof(float);
}
constexpr size_t dq_smem(int d) {
  return 4 * tile_bytes(d) + score_bytes() + 2 * kTile * sizeof(float);
}

}  // namespace simt

// ===================================================================== bf16

namespace tc {

constexpr int kWarps = 4;  // 16 rows of the 64-row tile each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {  // rounds to nearest even
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b for a 16x16 A (row-major) and a 16x8 B (column-major), f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of a row-major
// tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = t + (r0 + lane / 4) * ld + k0 + (lane % 4) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (k 16 x n 8) whose column n is row n0 + n of a row-major tile,
// k running along the row from k0
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* t, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = t + (n0 + lane / 4) * ld + k0 + (lane % 4) * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragments (k 16 x n 8) of the two column tiles n0 and n0 + 8 of a
// row-major tile whose ROW is k (from k0): one ldmatrix.x4.trans. b[0], b[1]
// belong to n0, b[2], b[3] to n0 + 8.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* t, int ld, int k0,
                                             int n0) {
  const int lane = threadIdx.x & 31, mat = lane / 8;
  const bf16* p = t + (k0 + (mat & 1) * 8 + lane % 8) * ld + n0 + (mat >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// the A fragment (16 rows x k 16) of columns [16 kk, 16 kk + 16) of a 16x64
// score block held as 8 accumulator tiles of 8 columns, rounded to bf16
__device__ __forceinline__ void scores_as_a(uint32_t (&a)[4], const float (&s)[8][4], int kk) {
  a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// acc (16 x D) += A (16 x 64, from scores) . X (64 x D, rows of a row-major tile)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&s)[8][4],
                                           const bf16* x) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    scores_as_a(a, s, kk);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      load_b_trans(b, x, D + 8, 16 * kk, 16 * dn);
      mma(acc[2 * dn], a, b[0], b[1]);
      mma(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// s (16 x 64) = rows [r0, r0 + 16) of tile a times the 64 rows of tile b, over D
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* a, int r0, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[4];
    load_a(fa, a, D + 8, r0, 16 * ks);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b0, b1;
      load_b(b0, b1, b, D + 8, 8 * nt, 16 * ks);
      mma(s[nt], fa, b0, b1);
    }
  }
}

// rows [r0, r0 + 64) of head h into a [64][D + 8] bf16 tile in 16-byte
// copies (the wrapper checks the alignment they need); rows past n are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, View<const bf16> src, int b, int h, int r0,
                                          int n) {
  constexpr int kChunks = D / 8;
  const bf16* base = src.p + b * src.sb + static_cast<long long>(h) * D;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) val = *reinterpret_cast<const uint4*>(base + row * src.sn + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// rows [r0 + warp row, ...) of a 16 x D accumulator block, divided by the
// row's divisor, into a packed bf16 tensor
template <int D>
__device__ __forceinline__ void store_rows(View<bf16> dst, int b, int h, int row0, int n,
                                           const float (&acc)[D / 8][4], const float (&div)[2]) {
  const int lane = threadIdx.x & 31;
  bf16* base = dst.p + b * dst.sb + static_cast<long long>(h) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lane / 4 + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(base + row * dst.sn + 8 * dt + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc[dt][2 * half] / div[half], acc[dt][2 * half + 1] / div[half]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<bf16> o,
         float* __restrict__ lse, int heads, int nq, int nk, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* kts = qs + kTile * (D + 8);
  bf16* vs = kts + kTile * (D + 8);
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x / 32);

  load_tile<D>(qs, q, b, h, q0, nq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows lane/4 and lane/4 + 8
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(kts, k, b, h, k0, nk);
    load_tile<D>(vs, v, b, h, k0, nk);
    __syncthreads();
    float s[8][4];
    scores<D>(s, qs, r0, kts);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k0 + 8 * nt + (lane % 4) * 2 + (e & 1) < nk;
        s[nt][e] = in ? scale * s[nt][e] : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));  // finite: every tile has a valid key
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this lane's share of the row sum, reduced at the end
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e / 2]);
        l[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    accumulate<D>(acc, s, vs);  // masked keys have p = 0 and v = 0
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_rows<D>(o, b, h, q0 + r0, nq, acc, l);
  if (lane % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + lane / 4 + 8 * half;
      if (row < nq) lse[static_cast<long long>(bh) * nq + row] = m[half] + logf(l[half]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<const bf16> dout,
              const float* __restrict__ lse, const float* __restrict__ delta, View<bf16> dk,
              View<bf16> dv, int heads, int nq, int nk, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* kts = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = kts + kTile * (D + 8);
  bf16* qs = vs + kTile * (D + 8);
  bf16* dos = qs + kTile * (D + 8);
  float* ls = reinterpret_cast<float*>(dos + kTile * (D + 8));
  float* dl = ls + kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x / 32);
  const bool key_in[2] = {k0 + r0 + lane / 4 < nk, k0 + r0 + lane / 4 + 8 < nk};

  load_tile<D>(kts, k, b, h, k0, nk);
  load_tile<D>(vs, v, b, h, k0, nk);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
  for (int q0 = 0; q0 < nq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, q, b, h, q0, nq);
    load_tile<D>(dos, dout, b, h, q0, nq);
    load_row_stats(ls, dl, lse, delta, bh, q0, nq);
    __syncthreads();
    // rows: this warp's 16 keys; columns: the tile's 64 queries
    float pt[8][4], dst[8][4];
    scores<D>(pt, kts, r0, qs);
    scores<D>(dst, vs, r0, dos);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + (lane % 4) * 2 + (e & 1);
        const float p = key_in[e / 2] && q0 + i < nq ? expf(scale * pt[nt][e] - ls[i]) : 0.f;
        dst[nt][e] = p * (dst[nt][e] - dl[i]) * scale;
        pt[nt][e] = p;
      }
    accumulate<D>(dva, pt, dos);  // dV += P^T dO, p rounded to bf16
    accumulate<D>(dka, dst, qs);  // dK += dS^T Q, ds rounded to bf16
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, b, h, k0 + r0, nk, dka, one);
  store_rows<D>(dv, b, h, k0 + r0, nk, dva, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<const bf16> dout,
            const float* __restrict__ lse, const float* __restrict__ delta, View<bf16> dq,
            int heads, int nq, int nk, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + kTile * (D + 8);
  bf16* kts = dos + kTile * (D + 8);
  bf16* vs = kts + kTile * (D + 8);
  float* ls = reinterpret_cast<float*>(vs + kTile * (D + 8));
  float* dl = ls + kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x / 32);

  load_tile<D>(qs, q, b, h, q0, nq);
  load_tile<D>(dos, dout, b, h, q0, nq);
  load_row_stats(ls, dl, lse, delta, bh, q0, nq);
  __syncthreads();
  const int i0 = r0 + lane / 4;
  const bool query_in[2] = {q0 + i0 < nq, q0 + i0 + 8 < nq};
  const float row_lse[2] = {ls[i0], ls[i0 + 8]}, row_delta[2] = {dl[i0], dl[i0 + 8]};
  float dqa[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_tile<D>(kts, k, b, h, k0, nk);
    load_tile<D>(vs, v, b, h, k0, nk);
    __syncthreads();
    // rows: this warp's 16 queries; columns: the tile's 64 keys
    float s[8][4], dp[8][4];
    scores<D>(s, qs, r0, kts);
    scores<D>(dp, dos, r0, vs);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 8 * nt + (lane % 4) * 2 + (e & 1);
        const float p =
            query_in[e / 2] && j < nk ? expf(scale * s[nt][e] - row_lse[e / 2]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e / 2]) * scale;
      }
    accumulate<D>(dqa, s, kts);  // dQ += dS K, ds rounded to bf16
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, b, h, q0 + r0, nq, dqa, one);
}

constexpr size_t tile_bytes(int d) { return sizeof(bf16) * kTile * (d + 8); }
constexpr size_t fwd_smem(int d) { return 3 * tile_bytes(d); }
constexpr size_t bwd_smem(int d) { return 4 * tile_bytes(d) + 2 * kTile * sizeof(float); }

}  // namespace tc

// ===================================================================== host

template <typename T>
View<const T> in_view(const void* p, const long long* st) {
  return {static_cast<const T*>(p), st[0], st[1]};
}
template <typename T>
View<T> out_view(void* p, const long long* st) {
  return {static_cast<T*>(p), st[0], st[1]};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Shape {
  int batch, heads, nq, nk;
  float scale;
};

template <int D>
cudaError_t fwd_f32(void* const* ptr, const long long* st, float* lse, Shape s,
                    cudaStream_t stream) {
  const size_t smem = simt::fwd_smem(D);
  cudaError_t err = allow_smem(simt::attn_fwd<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.nq + kTile - 1) / kTile, s.batch * s.heads);
  simt::attn_fwd<D><<<grid, simt::kThreads, smem, stream>>>(
      in_view<float>(ptr[0], st), in_view<float>(ptr[1], st + 2), in_view<float>(ptr[2], st + 4),
      out_view<float>(ptr[3], st + 6), lse, s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_bf16(void* const* ptr, const long long* st, float* lse, Shape s,
                     cudaStream_t stream) {
  const size_t smem = tc::fwd_smem(D);
  cudaError_t err = allow_smem(tc::attn_fwd<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.nq + kTile - 1) / kTile, s.batch * s.heads);
  tc::attn_fwd<D><<<grid, tc::kThreads, smem, stream>>>(
      in_view<bf16>(ptr[0], st), in_view<bf16>(ptr[1], st + 2), in_view<bf16>(ptr[2], st + 4),
      out_view<bf16>(ptr[3], st + 6), lse, s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_f32(void* const* ptr, const long long* st, const float* lse, const float* delta,
                    Shape s, cudaStream_t stream) {
  const auto q = in_view<float>(ptr[0], st), k = in_view<float>(ptr[1], st + 2);
  const auto v = in_view<float>(ptr[2], st + 4), dout = in_view<float>(ptr[3], st + 6);
  const int bh = s.batch * s.heads;
  const size_t smem_kv = simt::dkdv_smem(D), smem_q = simt::dq_smem(D);
  cudaError_t err = allow_smem(simt::attn_bwd_dkdv<D>, smem_kv);
  if (err != cudaSuccess) return err;
  simt::attn_bwd_dkdv<D><<<dim3((s.nk + kTile - 1) / kTile, bh), simt::kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, out_view<float>(ptr[5], st + 10),
      out_view<float>(ptr[6], st + 12), s.heads, s.nq, s.nk, s.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(simt::attn_bwd_dq<D>, smem_q)) != cudaSuccess) return err;
  simt::attn_bwd_dq<D><<<dim3((s.nq + kTile - 1) / kTile, bh), simt::kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, out_view<float>(ptr[4], st + 8), s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_bf16(void* const* ptr, const long long* st, const float* lse, const float* delta,
                     Shape s, cudaStream_t stream) {
  const auto q = in_view<bf16>(ptr[0], st), k = in_view<bf16>(ptr[1], st + 2);
  const auto v = in_view<bf16>(ptr[2], st + 4), dout = in_view<bf16>(ptr[3], st + 6);
  const int bh = s.batch * s.heads;
  const size_t smem = tc::bwd_smem(D);
  cudaError_t err = allow_smem(tc::attn_bwd_dkdv<D>, smem);
  if (err != cudaSuccess) return err;
  tc::attn_bwd_dkdv<D><<<dim3((s.nk + kTile - 1) / kTile, bh), tc::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, out_view<bf16>(ptr[5], st + 10), out_view<bf16>(ptr[6], st + 12),
      s.heads, s.nq, s.nk, s.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(tc::attn_bwd_dq<D>, smem)) != cudaSuccess) return err;
  tc::attn_bwd_dq<D><<<dim3((s.nq + kTile - 1) / kTile, bh), tc::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, out_view<bf16>(ptr[4], st + 8), s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

}  // namespace

// ptr: q, k, v (B, Nq|Nk|Nk, H*D), out (B, Nq, H*D); st: (batch stride, row
// stride) of each, in elements, last stride 1. lse: (B, H, Nq) f32,
// contiguous. All four tensors f32 (is_bf16 = 0) or all bf16; d in {32, 64,
// 128}. bf16 tensors start 16-byte aligned with strides that are multiples
// of 8.
extern "C" int ks_short_attention_fwd(void* const* ptr, const long long* st, void* lse, int batch,
                                      int heads, int nq, int nk, int d, float scale, int is_bf16,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<float*>(lse);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (d * 2 + (is_bf16 ? 1 : 0)) {
    case 64: err = fwd_f32<32>(ptr, st, l, shape, s); break;
    case 65: err = fwd_bf16<32>(ptr, st, l, shape, s); break;
    case 128: err = fwd_f32<64>(ptr, st, l, shape, s); break;
    case 129: err = fwd_bf16<64>(ptr, st, l, shape, s); break;
    case 256: err = fwd_f32<128>(ptr, st, l, shape, s); break;
    case 257: err = fwd_bf16<128>(ptr, st, l, shape, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// ptr: q, k, v, do (inputs), dq, dk, dv (outputs), each with its (batch
// stride, row stride) in st; lse and delta (B, H, Nq) f32, contiguous.
extern "C" int ks_short_attention_bwd(void* const* ptr, const long long* st, const void* lse,
                                      const void* delta, int batch, int heads, int nq, int nk,
                                      int d, float scale, int is_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (d * 2 + (is_bf16 ? 1 : 0)) {
    case 64: err = bwd_f32<32>(ptr, st, l, dl, shape, s); break;
    case 65: err = bwd_bf16<32>(ptr, st, l, dl, shape, s); break;
    case 128: err = bwd_f32<64>(ptr, st, l, dl, shape, s); break;
    case 129: err = bwd_bf16<64>(ptr, st, l, dl, shape, s); break;
    case 256: err = bwd_f32<128>(ptr, st, l, dl, shape, s); break;
    case 257: err = bwd_bf16<128>(ptr, st, l, dl, shape, s); break;
    default: break;
  }
  return static_cast<int>(err);
}
