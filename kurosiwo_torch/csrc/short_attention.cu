// Non-causal multi-head attention on the packed (B, N, H*D) layout, forward
// (out, lse) and backward (dq, dk, dv): the attention of every transformer of
// the zoo (ViT/MAE, BiT-CD, ChangeFormer, TransUNet-CD).
//
// Replaces the TPU kernels kurosiwo_tpu/ops/pallas_attention.py::
// _short_fwd_kernel (:259, launched by _short_fwd_local, :332) and
// _short_bwd_kernel (:283, launched by _short_bwd_local, :392). There delta =
// sum_d(do * out) is computed by the caller (_short_vjp_bwd, :385); here the
// wgmma backward computes it itself, and the other kernels take it from the
// caller.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes. At the
// MAE ViT-L batch-64 shapes (H 16, D 64, bf16; t = one operand's bytes) a
// decoder layer (N 196) must move q, k, v, out and lse (4t + lse, 103.6 MB)
// in 30.9 us forward, and the wgmma backward q, k, v, do, out, lse, dq, dk,
// dv (8t + lse, 206.3 MB) in 61.6 us; an encoder layer (N 49) 25.9 MB (7.7
// us) and 51.6 MB (15.4 us). Its products, 10.1 GFLOP forward and 25.2
// backward per decoder layer, need 10.2 and 25.4 us at the bf16 rate.
//
// Three families of kernels (a fourth, for long queries over at most 64
// keys, is long_attention.cu's); the wrapper's plan (ops/short_attention.py:
// short_plan) names one for each call and the entry points refuse a call the
// named kernel does not take. Every tensor comes with its own batch and row
// strides (in elements), so q, k and v may be the three column-thirds of the
// qkv projection, and dq, dk and dv the thirds of its gradient, with no copy.
//  * wgmma (bf16, D 64 with Nq, Nk <= 256 and D 128 with Nk <= 128: the
//    MAE's encoder (N 49) and decoder (N 196)). A work item is one (batch,
//    head), held whole in shared memory, so the softmax is exact over the
//    row in one pass, as on the TPU. Operands are read through rank-4 TMA
//    maps over the (B, H, N, D) views (rows past N read as 0, never the next
//    head's) into B128 tiles of 64 rows; products are wgmma (hopper.cuh).
//    A grid of resident blocks walks the items with the next item's copies
//    in flight (one block an item where two forward stages do not fit).
//     - forward (hw::short_fwd): an item's Q, K and V in one stage of two.
//       Each warpgroup takes 64-query tiles: S = Q K^T (SS, one block of 64
//       keys at a time, the last one m64n16 where the head's last keys fit
//       in 16: 196 keys take 208), -inf past Nk, m, p and l in f32 (base 2),
//       p / l rounded to bf16 as the RS A operand of O = (P / l) V, as the
//       TPU kernel rounds; lse in natural log.
//     - backward (hw::short_bwd), one fused kernel, 5 products a tile, no
//       float atomics: consumer warpgroups own 64 or 128 of the item's keys,
//       resident with V; Q, dO and out stream in by 64-query tile on a ring
//       of two TMA stages. A producer warpgroup starts the copies and stages
//       lse (+inf past Nq, so p = 0 there); two of its warps compute delta =
//       sum_d dO out of each tile in f32 from the tile of out. Per key tile:
//       S^T = K Q^T and dP^T = V dO^T (SS; in halves of 32 queries where a
//       warpgroup's dK and dV take 128 registers), P^T and dS^T in f32, then
//       dV += P^T dO and dK += dS^T Q (RS, p and ds rounded to bf16). dS^T also
//       goes to shared memory; after a barrier of the consumers, one of them
//       computes dQ of the tile = dS K as one chain over every key (dS^T as
//       MN-major A from shared memory) and writes it once.
//  * mma_sync (bf16 heads longer than 256 over more than 64 keys, or at D 32
//    or D 128, and D 128 with Nk > 128): mma.sync
//    m16n8k16 tensor-core products with f32 accumulators, 4 warps of 16 rows,
//    one block per (64-row tile, batch x head), K/V tiles streamed with an
//    online softmax (out = acc / l); backward one kernel per (key tile) for
//    dk/dv and one per (query tile) for dq, both recomputing p = exp(s -
//    lse). Scores stay in registers as the A operand of the next product;
//    tiles are bf16 in shared memory with rows padded by 8 elements. Each
//    tile is loaded, then used, with a barrier between.
//  * simt (f32, the parity path): f32 FMA on f32 tiles in shared memory, a
//    4x4 register tile of the 64x64 scores per thread of 256, rows padded by
//    one float. Bound by the FMA rate (67 TFLOP/s on CUDA cores).
// As in the TPU kernel, p and ds are rounded to the input type before their
// products in the backward. Deterministic: every sum in a fixed order.
#include "attention_hw.cuh"

namespace {

// ===================================================================== f32

namespace simt {

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

// ============================================================ bf16, wgmma

namespace hw {

constexpr int kMaxRows = 256;            // the longest head (queries or keys) the kernels take

// ------------------------------------------------------------- forward

// Shared memory of the forward: `stages` item stages of ceil(nq / 64) Q
// tiles, nkt K tiles and nkt V tiles, one mbarrier each, 1 KB of alignment
// slack.
__host__ __device__ constexpr uint32_t fwd_stage_bytes(int d, int nq, int nkt) {
  return ((nq + kRows - 1) / kRows + 2 * nkt) * tile_bytes(d);
}
__host__ __device__ constexpr uint32_t fwd_smem(int d, int nq, int nkt, int stages) {
  return stages * (fwd_stage_bytes(d, nq, nkt) + 8) + 1024;
}
// two stages (the next item's copies in flight) where they fit, else one
__host__ __device__ constexpr int fwd_stages(int d, int nq, int nkt) {
  return fwd_smem(d, nq, nkt, 2) <= kSmemLimit ? 2 : 1;
}

// One item is one (batch, head), held whole: its Q, K and V land in one
// stage, and warpgroup wg takes query tiles wg, wg + nwg, ... The block walks
// items blockIdx.x, + gridDim.x, ...; with two stages the next item's copies
// run while this one computes. The keys go in blocks of 64, the last TAIL
// (64, or 16 where the head's last keys fill at most 16 of their block: the
// decoder's 196 keys take 208, not 256). scale_log2 = scale * log2(e):
// exponents are in base 2.
template <int D, int NKT, int TAIL>
__global__ void __launch_bounds__(256)
short_fwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, View<bf16> o, float* __restrict__ lse,
          int heads, int items, int nq, int nk, int stages, float scale_log2) {
  constexpr uint32_t T = tile_bytes(D);
  extern __shared__ __align__(1024) unsigned char hw_smem[];
  const uint32_t base = (hopper::smem_addr(hw_smem) + 1023) & ~1023u;
  const int nqt = (nq + kRows - 1) / kRows;
  const uint32_t stage_bytes = fwd_stage_bytes(D, nq, NKT), bars = base + stages * stage_bytes;
  const int nwg = blockDim.x / 128, wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  auto load_item = [&](int item, int stage) {  // thread 0: every copy of one item into a stage
    const int b = item / heads, h = item % heads;
    const uint32_t st = base + stage * stage_bytes, bar = bars + 8 * stage;
    mbar_arrive_expect_tx(bar, stage_bytes);
    for (int t = 0; t < nqt; ++t) load_tile<D>(st + t * T, qmap, t * kRows, h, b, bar);
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      load_tile<D>(st + (nqt + j) * T, kmap, j * kRows, h, b, bar);
      load_tile<D>(st + (nqt + NKT + j) * T, vmap, j * kRows, h, b, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int stage = 0; stage < stages; ++stage) mbar_init(bars + 8 * stage, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int stage = 0; stage < stages && blockIdx.x + stage * gridDim.x < items; ++stage)
      load_item(blockIdx.x + stage * gridDim.x, stage);

  float s[NKT][32], acc[D / 2];
  uint32_t p[NKT][4][4];  // P / l as A fragments: p[j][kk] holds keys 64 j + 16 kk .. + 16
  // f(scores, fragments, j) for each key block j, the last one TAIL keys wide
  auto blocks = [&](auto&& f) {
#pragma unroll
    for (int j = 0; j < NKT - 1; ++j) f(s[j], p[j], j);
    f(reinterpret_cast<float(&)[TAIL / 2]>(s[NKT - 1]),
      reinterpret_cast<uint32_t(&)[TAIL / 16][4]>(p[NKT - 1]), NKT - 1);
  };
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int stage = n % stages;
    const uint32_t st = base + stage * stage_bytes;
    const int b = item / heads, h = item % heads;
    mbar_wait(bars + 8 * stage, (n / stages) & 1);
    for (int qt = wg; qt < nqt; qt += nwg) {
      const uint32_t qtile = st + qt * T;
      // S = Q K^T over D, one key block at a time
      blocks([&](auto& sj, auto&, int) {
        zero(sj);
        fence_regs(sj);
      });
      wgmma_fence();
      blocks([&](auto& sj, auto&, int j) {
        constexpr int W = 2 * static_cast<int>(sizeof(sj) / sizeof(float));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<W, 0, 0>(sj, kmajor(qtile, kk), kmajor(st + (nqt + j) * T, kk), kk > 0);
      });
      wgmma_commit();
      wgmma_wait<0>();
      // the exact softmax over the whole row: keys past nk to -inf
      float mx[2] = {-INFINITY, -INFINITY};
      blocks([&](auto& sj, auto&, int j) {
        fence_regs(sj);
#pragma unroll
        for (int i = 0; i < static_cast<int>(sizeof(sj) / sizeof(float)); ++i) {
          if (64 * j + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= nk) sj[i] = -INFINITY;
          mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sj[i]);
        }
      });
      float neg_m[2], l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) neg_m[r] = -quad_max(mx[r]) * scale_log2;  // finite: nk >= 1
      blocks([&](auto& sj, auto&, int) {
#pragma unroll
        for (int i = 0; i < static_cast<int>(sizeof(sj) / sizeof(float)); ++i) {
          sj[i] = ex2(fmaf(sj[i], scale_log2, neg_m[(i / 2) & 1]));
          l[(i / 2) & 1] += sj[i];
        }
      });
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
      }
      blocks([&](auto& sj, auto& pj, int) {
        constexpr int R = static_cast<int>(sizeof(sj) / sizeof(float));
#pragma unroll
        for (int i = 0; i < R; ++i) sj[i] *= inv[(i / 2) & 1];
        hopper::accumulator_as_a<2 * R>(pj, sj);  // p / l rounded to bf16, as the TPU kernel
      });
      // O = (P / l) V over the keys
      zero(acc);
      fence_regs(acc);
      blocks([&](auto&, auto& pj, int) { fence_regs(pj); });
      wgmma_fence();
      blocks([&](auto&, auto& pj, int j) {
#pragma unroll
        for (int kk = 0; kk < static_cast<int>(sizeof(pj) / sizeof(pj[0])); ++kk)
          wgmma_rs<D>(acc, pj[kk], mnmajor(st + (nqt + NKT + j) * T, kk), (j | kk) > 0);
      });
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      blocks([&](auto&, auto& pj, int) { fence_regs(pj); });
      store_acc<D>(o.p + b * o.sb + static_cast<long long>(h) * D, o.sn, qt * kRows, nq, acc);
      if (lane % 4 == 0) {
        const int r = qt * kRows + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (r + 8 * hh < nq)
            lse[static_cast<long long>(item) * nq + r + 8 * hh] = -neg_m[hh] * kLn2 + logf(l[hh]);
      }
    }
    __syncthreads();  // every warpgroup is done with this stage
    if (threadIdx.x == 0 && item + stages * gridDim.x < items)
      load_item(item + stages * gridDim.x, stage);
  }
}

// ------------------------------------------------------------- backward

// NWG consumer warpgroups, each owning KT 64-key tiles of the item, and a
// producer warpgroup. Shared memory: K and V of an item (two item stages
// where they fit, so the next item's land during this one), a ring of
// query-tile stages (Q, dO, out), dS^T of one query tile over every key
// ([keys][64 queries] bf16, B128), lse * log2(e) and delta per ring stage,
// the mbarriers and 1 KB of alignment slack.
template <int D, int NWG, int KT>
struct BwdLayout {
  static constexpr int kKeyTiles = NWG * KT, kRing = 2;
  static constexpr uint32_t T = tile_bytes(D);
  static constexpr uint32_t kKv = 2 * kKeyTiles * T, kStage = 3 * T;
  static constexpr uint32_t kDsT = kKeyTiles * kRows * 128, kStats = 2 * kRows * 4;
  static constexpr uint32_t kFixed = kRing * (kStage + kStats) + kDsT + 8 * (4 + 3 * kRing) + 1024;
  static constexpr int kKvStages = 2 * kKv + kFixed <= kSmemLimit ? 2 : 1;
  static constexpr uint32_t kv = 0, ring = kKvStages * kKv, dst = ring + kRing * kStage,
                            stats = dst + kDsT, bars = stats + kRing * kStats;
  // barriers: K/V full and empty per item stage; full (copies and lse),
  // dready (delta) and empty per ring stage
  static constexpr uint32_t kv_full = bars, kv_empty = kv_full + 16, full = kv_empty + 16,
                            dready = full + 8 * kRing, empty = dready + 8 * kRing;
  static constexpr uint32_t bytes = empty + 8 * kRing + 1024;
  static constexpr int kThreads = (NWG + 1) * 128;
  // registers after setmaxnreg: the launch's share is 65536 / (threads *
  // blocks an SM) (128 or 168); the producer gives up all but 40
  static constexpr int kBlocks = NWG == 1 ? 2 : 1, kProducerRegs = 40;
  static constexpr int kConsumerRegs = NWG == 1 ? 216 : 232;
  // queries of one S^T / dP^T product: where a warpgroup's dK and dV take
  // 128 registers, the 64-query tile goes in two halves of 32
  static constexpr int kQn = KT == 2 || D == 128 ? 32 : 64;
};

template <int D, int NWG, int KT>
__global__ void __launch_bounds__(BwdLayout<D, NWG, KT>::kThreads, BwdLayout<D, NWG, KT>::kBlocks)
short_bwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
          const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse, View<bf16> dq,
          View<bf16> dk, View<bf16> dv, int heads, int items, int nq, int nk, float scale) {
  using L = BwdLayout<D, NWG, KT>;
  constexpr int R = L::kRing, KVS = L::kKvStages, NKT = L::kKeyTiles;
  constexpr int kConsumers = NWG * 128;
  constexpr uint32_t T = L::T;
  constexpr int QN = L::kQn, HALVES = kRows / QN;
  constexpr bool F = KT == 2;  // descriptors formed just before each product
  // dQ's product runs beside dK and dV's where the registers allow
  constexpr bool kOverlap = D == 64 && KT == 1;
  extern __shared__ __align__(1024) unsigned char hw_smem[];
  const uint32_t raw = hopper::smem_addr(hw_smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = hw_smem + (base - raw);
  float* const stats = reinterpret_cast<float*>(sbase + L::stats);
  const int nqt = (nq + kRows - 1) / kRows;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KVS; ++s) {
      mbar_init(base + L::kv_full + 8 * s, 1);
      mbar_init(base + L::kv_empty + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < R; ++s) {
      mbar_init(base + L::full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(base + L::dready + 8 * s, 64);  // the delta threads
      mbar_init(base + L::empty + 8 * s, 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {  // producer warpgroup
    hopper::regs_dec<L::kProducerRegs>();
    const int t = threadIdx.x - kConsumers;
    if (t < 32) {  // warp 0: lane 0 starts the copies, every lane stages lse
      int n = 0, g = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int b = item / heads, h = item % heads, kvs = n % KVS;
        if (lane == 0) {
          const uint32_t kv = base + L::kv + kvs * L::kKv, bar = base + L::kv_full + 8 * kvs;
          mbar_wait(base + L::kv_empty + 8 * kvs, ((n / KVS) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, L::kKv);
          for (int j = 0; j < NKT; ++j) {
            load_tile<D>(kv + j * T, kmap, j * kRows, h, b, bar);
            load_tile<D>(kv + (NKT + j) * T, vmap, j * kRows, h, b, bar);
          }
        }
        for (int qt = 0; qt < nqt; ++qt, ++g) {
          const int s = g % R;
          const uint32_t full = base + L::full + 8 * s, tiles = base + L::ring + s * L::kStage;
          mbar_wait(base + L::empty + 8 * s, ((g / R) & 1) ^ 1);
          float* st = stats + s * 2 * kRows;
          for (int i = lane; i < kRows; i += 32) {
            const int row = qt * kRows + i;  // +inf past nq: p = 0 there
            st[i] = row < nq ? lse[static_cast<long long>(item) * nq + row] * kLog2e : INFINITY;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(full, L::kStage);
            load_tile<D>(tiles, qmap, qt * kRows, h, b, full);
            load_tile<D>(tiles + T, domap, qt * kRows, h, b, full);
            load_tile<D>(tiles + 2 * T, omap, qt * kRows, h, b, full);
          } else {
            mbar_arrive(full);
          }
        }
      }
    } else if (t < 96) {  // warps 1 and 2: delta = sum_d dO out of one query row each, in f32
      const int r = t - 32;
      int g = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x)
        for (int qt = 0; qt < nqt; ++qt, ++g) {
          const int s = g % R;
          mbar_wait(base + L::full + 8 * s, (g / R) & 1);
          const unsigned char* tiles = sbase + L::ring + s * L::kStage;
          float acc = 0.f;
          // one 16-byte pair at a time: unrolled, the loads would take more
          // than the producer's 40 registers
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
#pragma unroll 1
            for (int k = 0; k < 8; ++k) {
              const uint32_t off = c * kRows * 128 + r * 128 + ((k ^ (r & 7)) << 4);
              acc = dot8(*reinterpret_cast<const uint4*>(tiles + T + off),
                         *reinterpret_cast<const uint4*>(tiles + 2 * T + off), acc);
            }
          stats[s * 2 * kRows + kRows + r] = acc;
          mbar_arrive(base + L::dready + 8 * s);
        }
    }
  } else {  // consumers: warpgroup wg owns key tiles wg * KT .. + KT
    hopper::regs_inc<L::kConsumerRegs>();
    const int w4 = (threadIdx.x / 32) % 4;
    const float scale_log2 = scale * kLog2e;
    float sT[QN / 2], dpT[QN / 2], dka[KT][D / 2], dva[KT][D / 2];
    uint32_t pa[QN / 16][4], da[QN / 16][4];  // P^T, dS^T as A fragments: step kk, queries 16 kk ..
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      zero(dka[j]);
      zero(dva[j]);
    }
    int n = 0, g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int kvs = n % KVS;
      const uint32_t kv = base + L::kv + kvs * L::kKv;
      mbar_wait(base + L::kv_full + 8 * kvs, (n / KVS) & 1);
      for (int qt = 0; qt * kRows < nq; ++qt, ++g) {
        const int s = g % R;
        const uint32_t qtile = base + L::ring + s * L::kStage, dotile = qtile + T;
        mbar_wait(base + L::full + 8 * s, (g / R) & 1);
        mbar_wait(base + L::dready + 8 * s, (g / R) & 1);
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int kt = wg * KT + j;
          const uint32_t ktile = kv + kt * T, vtile = kv + (NKT + kt) * T;
#pragma unroll
          for (int hq = 0; hq < HALVES; ++hq) {
            // S^T = K Q^T and dP^T = V dO^T: rows this warpgroup's keys,
            // columns queries hq QN .. + QN of the tile (rows of Q and dO)
            const uint32_t qrows = qtile + hq * QN * 128, dorows = dotile + hq * QN * 128;
            zero(sT);
            zero(dpT);
            fence_regs(sT);
            fence_regs(dpT);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss<QN, 0, 0>(sT, kmajor(fresh<F>(ktile), kk), kmajor(fresh<F>(qrows), kk),
                                 kk > 0);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss<QN, 0, 0>(dpT, kmajor(fresh<F>(vtile), kk), kmajor(fresh<F>(dorows), kk),
                                 kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sT);
            fence_regs(dpT);
            // P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta) scale; keys past nk: p = 0
            const int key = kt * kRows + 16 * w4 + lane / 4;
            const bool key_in[2] = {key < nk, key + 8 < nk};
#pragma unroll
            for (int jj = 0; jj < QN / 8; ++jj) {
              const int c = hq * QN + 8 * jj + 2 * (lane % 4);
              const uint32_t sst = base + L::stats + s * 2 * kRows * 4 + 4 * c;
              const float2 l2 = lds2(sst), d2 = lds2(sst + 4 * kRows);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * jj + e;
                float p = ex2(fmaf(sT[i], scale_log2, -(e & 1 ? l2.y : l2.x)));
                p = key_in[e / 2] ? p : 0.f;
                sT[i] = p;
                dpT[i] = p * (dpT[i] - (e & 1 ? d2.y : d2.x)) * scale;
              }
            }
            hopper::accumulator_as_a<QN>(pa, sT);  // p rounded to bf16 for dV
            hopper::accumulator_as_a<QN>(da, dpT);  // ds rounded to bf16 for dK and dQ
            if (j == 0 && hq == 0) bar_sync(1, kConsumers);  // the last dQ product is done
            // dS^T rows of this warpgroup's keys into shared memory: da[kk][i]
            // holds key row 16 w4 + lane / 4 + 8 (i & 1), queries hq QN + 16 kk
            // + 8 (i / 2) + 2 (lane % 4) and + 1
            const uint32_t dsrow = base + L::dst + kt * kRows * 128;
#pragma unroll
            for (int kk = 0; kk < QN / 16; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = 16 * w4 + lane / 4 + 8 * (i & 1);
                const int chunk = hq * QN / 8 + 2 * kk + (i >> 1);
                sts32(dsrow + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * (lane % 4), da[kk][i]);
              }
            // dV += P^T dO, dK += dS^T Q over these queries (A from registers)
            const int acc0 = qt > 0 || hq > 0;
            fence_regs(dka[j]);
            fence_regs(dva[j]);
            fence_regs(pa);
            fence_regs(da);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < QN / 16; ++kk)
              wgmma_rs<D>(dva[j], pa[kk], mnmajor(fresh<F>(dotile), hq * QN / 16 + kk), acc0 | kk);
#pragma unroll
            for (int kk = 0; kk < QN / 16; ++kk)
              wgmma_rs<D>(dka[j], da[kk], mnmajor(fresh<F>(qtile), hq * QN / 16 + kk), acc0 | kk);
            wgmma_commit();
            if (j + 1 < KT || hq + 1 < HALVES || !kOverlap) {
              wgmma_wait<0>();
              fence_regs(dka[j]);
              fence_regs(dva[j]);
              fence_regs(pa);
              fence_regs(da);
            }
          }
        }
        hopper::fence_proxy_async();  // the dS^T stores, visible to wgmma
        bar_sync(2, kConsumers);      // dS^T of every key is in place
        if (qt % NWG == wg) {
          // dQ = dS K: one chain over every key for each 64 of D, dS^T as
          // MN-major A, K's 64-column block as MN-major B
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            float dqa[32];
            zero(dqa);
            fence_regs(dqa);
            wgmma_fence();
#pragma unroll
            for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                hopper::wgmma_m64n64k16<1, 1>(
                    dqa,
                    desc_b128(fresh<F>(base + L::dst) + kt * kRows * 128 + kk * 2048, 8192, 1024),
                    mnmajor(fresh<F>(kv) + kt * T + c * kRows * 128, kk), (kt | kk) > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqa);
            const long long at = (item / heads) * dq.sb + static_cast<long long>(item % heads) * D;
            store_acc<64>(dq.p + at + 64 * c, dq.sn, qt * kRows, nq, dqa);
          }
        } else {
          wgmma_wait<0>();
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          fence_regs(dka[j]);
          fence_regs(dva[j]);
        }
        fence_regs(pa);
        fence_regs(da);
        if (lane == 0) mbar_arrive(base + L::empty + 8 * s);  // this warp is done with the stage
      }
      const int b = item / heads;
      const long long off = static_cast<long long>(item % heads) * D;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        store_acc<D>(dk.p + b * dk.sb + off, dk.sn, (wg * KT + j) * kRows, nk, dka[j]);
        store_acc<D>(dv.p + b * dv.sb + off, dv.sn, (wg * KT + j) * kRows, nk, dva[j]);
      }
      if (lane == 0) mbar_arrive(base + L::kv_empty + 8 * kvs);
    }
  }
}

}  // namespace hw

// ===================================================================== host

// The kernels; the wrapper's plan (ops/short_attention.py: short_plan) names
// one of them for each call.
enum Kernel { kSimt = 0, kMmaSync = 1, kWgmma = 2 };

// whether `kernel` computes a call of this dtype, head size and length: the
// one check of the plan. The wgmma backward holds a warpgroup's dK and dV in
// registers: 128 keys of D 64, or 64 of D 128, per consumer warpgroup.
bool takes(int kernel, bool bf16, int d, int nq, int nk) {
  if (nq < 1 || nk < 1) return false;
  const bool head = d == 32 || d == 64 || d == 128;
  switch (kernel) {
    case kSimt: return !bf16 && head;
    case kMmaSync: return bf16 && head;
    case kWgmma:
      return bf16 && nq <= hw::kMaxRows && ((d == 64 && nk <= 256) || (d == 128 && nk <= 128));
    default: return false;
  }
}

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

// ptr: q, k, v, do, out (unused here), dq, dk, dv
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
      q, k, v, dout, lse, delta, out_view<float>(ptr[6], st + 12),
      out_view<float>(ptr[7], st + 14), s.heads, s.nq, s.nk, s.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(simt::attn_bwd_dq<D>, smem_q)) != cudaSuccess) return err;
  simt::attn_bwd_dq<D><<<dim3((s.nq + kTile - 1) / kTile, bh), simt::kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, out_view<float>(ptr[5], st + 10), s.heads, s.nq, s.nk, s.scale);
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
      q, k, v, dout, lse, delta, out_view<bf16>(ptr[6], st + 12), out_view<bf16>(ptr[7], st + 14),
      s.heads, s.nq, s.nk, s.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(tc::attn_bwd_dq<D>, smem)) != cudaSuccess) return err;
  tc::attn_bwd_dq<D><<<dim3((s.nq + kTile - 1) / kTile, bh), tc::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, out_view<bf16>(ptr[5], st + 10), s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

// ---- the wgmma kernels

int fwd_threads(int nq) { return tiles_of(nq) > 1 ? 256 : 128; }

template <int D, int NKT, int TAIL>
cudaError_t fwd_wgmma(void* const* ptr, const long long* st, float* lse, Shape s,
                      cudaStream_t stream) {
  const auto kernel = hw::short_fwd<D, NKT, TAIL>;
  static const cudaError_t attr = allow_smem(kernel, hw::kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int stages = hw::fwd_stages(D, s.nq, NKT), items = s.batch * s.heads;
  const uint32_t smem = hw::fwd_smem(D, s.nq, NKT, stages);
  const int threads = fwd_threads(s.nq);
  CUtensorMap qm, km, vm;
  if (!heads_map(&qm, ptr, st, 0, s, s.nq, D) || !heads_map(&km, ptr, st, 1, s, s.nk, D) ||
      !heads_map(&vm, ptr, st, 2, s, s.nk, D))
    return cudaErrorInvalidValue;
  const int grid = stages == 2 ? resident_grid(kernel, threads, smem, items) : items;
  hw::short_fwd<D, NKT, TAIL><<<grid, threads, smem, stream>>>(
      qm, km, vm, out_view<bf16>(ptr[3], st + 6), lse, s.heads, items, s.nq, s.nk, stages,
      s.scale * hw::kLog2e);
  return cudaGetLastError();
}

template <int D, int NWG, int KT>
cudaError_t bwd_wgmma(void* const* ptr, const long long* st, const float* lse, Shape s,
                      cudaStream_t stream) {
  using L = hw::BwdLayout<D, NWG, KT>;
  static const cudaError_t attr = allow_smem(hw::short_bwd<D, NWG, KT>, L::bytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[5];
  const int rows[5] = {s.nq, s.nk, s.nk, s.nq, s.nq};  // q, k, v, do, out
  for (int i = 0; i < 5; ++i)
    if (!heads_map(&m[i], ptr, st, i, s, rows[i], D)) return cudaErrorInvalidValue;
  const int items = s.batch * s.heads;
  const int grid = resident_grid(hw::short_bwd<D, NWG, KT>, L::kThreads, L::bytes, items);
  hw::short_bwd<D, NWG, KT><<<grid, L::kThreads, L::bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], lse, out_view<bf16>(ptr[5], st + 10),
      out_view<bf16>(ptr[6], st + 12), out_view<bf16>(ptr[7], st + 14), s.heads, items, s.nq,
      s.nk, s.scale);
  return cudaGetLastError();
}

// The backward's instantiation of a call: D 64 takes one warpgroup of one
// key tile (Nk <= 64), two of one (<= 128) or two of two (<= 256); D 128 two
// warpgroups of one key tile.
int bwd_variant(int d, int nk) {
  const int nkt = tiles_of(nk);
  if (d == 128) return 2;
  return nkt == 1 ? 0 : nkt == 2 ? 1 : 3;
}

// The forward's key blocks of a call: ceil(Nk / 64), the last one 16 keys
// wide where Nk's last block holds at most 16 keys, else 64
int fwd_tail(int nk) {
  return nk - (tiles_of(nk) - 1) * hw::kRows <= 16 ? 16 : 64;
}

#define KS_FWD_VARIANTS(X) \
  X(64, 1, 16) X(64, 1, 64) X(64, 2, 16) X(64, 2, 64) X(64, 3, 16) X(64, 3, 64) X(64, 4, 16) \
  X(64, 4, 64) X(128, 1, 16) X(128, 1, 64) X(128, 2, 16) X(128, 2, 64)
#define KS_FWD_KEY(D, NKT, TAIL) ((D) * 1024 + (NKT) * 128 + (TAIL))

cudaError_t launch_fwd_wgmma(void* const* ptr, const long long* st, float* lse, Shape s, int d,
                             cudaStream_t stream) {
  switch (KS_FWD_KEY(d, tiles_of(s.nk), fwd_tail(s.nk))) {
#define KS_CASE(D, NKT, TAIL)    \
  case KS_FWD_KEY(D, NKT, TAIL): \
    return fwd_wgmma<D, NKT, TAIL>(ptr, st, lse, s, stream);
    KS_FWD_VARIANTS(KS_CASE)
#undef KS_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bwd_wgmma(void* const* ptr, const long long* st, const float* lse, Shape s,
                             int d, cudaStream_t stream) {
  switch (bwd_variant(d, s.nk)) {
    case 0: return bwd_wgmma<64, 1, 1>(ptr, st, lse, s, stream);
    case 1: return bwd_wgmma<64, 2, 1>(ptr, st, lse, s, stream);
    case 2: return bwd_wgmma<128, 2, 1>(ptr, st, lse, s, stream);
    case 3: return bwd_wgmma<64, 2, 2>(ptr, st, lse, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

// shared memory and blocks an SM of the wgmma kernel of a call (which 0:
// forward, 1: backward)
void wgmma_footprint(int which, int d, int nq, int nk, long long* smem, int* blocks) {
  *smem = 0;
  *blocks = 0;
  if (which == 0) {
    const int nkt = tiles_of(nk), stages = hw::fwd_stages(d, nq, nkt);
    *smem = hw::fwd_smem(d, nq, nkt, stages);
    const int threads = fwd_threads(nq);
    switch (KS_FWD_KEY(d, nkt, fwd_tail(nk))) {
#define KS_CASE(D, NKT, TAIL)                                                               \
  case KS_FWD_KEY(D, NKT, TAIL):                                                            \
    *blocks = blocks_per_sm(hw::short_fwd<D, NKT, TAIL>, threads, *smem);                   \
    break;
      KS_FWD_VARIANTS(KS_CASE)
#undef KS_CASE
      default: *smem = 0; break;
    }
    return;
  }
#define KS_BWD(D, NWG, KT)                                                              \
  *smem = hw::BwdLayout<D, NWG, KT>::bytes;                                             \
  *blocks = blocks_per_sm(hw::short_bwd<D, NWG, KT>, hw::BwdLayout<D, NWG, KT>::kThreads, \
                          *smem);                                                       \
  break
  switch (bwd_variant(d, nk)) {
    case 0: KS_BWD(64, 1, 1);
    case 1: KS_BWD(64, 2, 1);
    case 2: KS_BWD(128, 2, 1);
    case 3: KS_BWD(64, 2, 2);
    default: break;
  }
#undef KS_BWD
}

}  // namespace

// ptr: q, k, v (B, Nq|Nk|Nk, H*D), out (B, Nq, H*D); st: (batch stride, row
// stride) of each, in elements, last stride 1. lse: (B, H, Nq) f32,
// contiguous. All four tensors f32 (is_bf16 = 0) or all bf16; d in {32, 64,
// 128}. bf16 tensors start 16-byte aligned with strides that are multiples
// of 8. kernel (Kernel) from the wrapper's plan. cudaErrorInvalidValue, and
// nothing launched, when the kernel does not take the call (or a tensor map
// cannot be made).
extern "C" int ks_short_attention_fwd(void* const* ptr, const long long* st, void* lse, int batch,
                                      int heads, int nq, int nk, int d, float scale, int is_bf16,
                                      int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, d, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<float*>(lse);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel * 256 + d) {
    case kSimt * 256 + 32: err = fwd_f32<32>(ptr, st, l, shape, s); break;
    case kSimt * 256 + 64: err = fwd_f32<64>(ptr, st, l, shape, s); break;
    case kSimt * 256 + 128: err = fwd_f32<128>(ptr, st, l, shape, s); break;
    case kMmaSync * 256 + 32: err = fwd_bf16<32>(ptr, st, l, shape, s); break;
    case kMmaSync * 256 + 64: err = fwd_bf16<64>(ptr, st, l, shape, s); break;
    case kMmaSync * 256 + 128: err = fwd_bf16<128>(ptr, st, l, shape, s); break;
    case kWgmma * 256 + 64:
    case kWgmma * 256 + 128:
      err = launch_fwd_wgmma(ptr, st, l, shape, d, s);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

// ptr: q, k, v, do, out (inputs), dq, dk, dv (outputs), each with its (batch
// stride, row stride) in st; lse (B, H, Nq) f32, contiguous; kernel as for
// the forward. The simt and mma_sync kernels take delta
// (B, H, Nq) f32 from the caller and do not read out; the wgmma kernel
// computes delta = sum_d(do * out) itself (delta may be null).
extern "C" int ks_short_attention_bwd(void* const* ptr, const long long* st, const void* lse,
                                      const void* delta, int batch, int heads, int nq, int nk,
                                      int d, float scale, int is_bf16, int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, d, nq, nk) || (kernel != kWgmma && delta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel * 256 + d) {
    case kSimt * 256 + 32: err = bwd_f32<32>(ptr, st, l, dl, shape, s); break;
    case kSimt * 256 + 64: err = bwd_f32<64>(ptr, st, l, dl, shape, s); break;
    case kSimt * 256 + 128: err = bwd_f32<128>(ptr, st, l, dl, shape, s); break;
    case kMmaSync * 256 + 32: err = bwd_bf16<32>(ptr, st, l, dl, shape, s); break;
    case kMmaSync * 256 + 64: err = bwd_bf16<64>(ptr, st, l, dl, shape, s); break;
    case kMmaSync * 256 + 128: err = bwd_bf16<128>(ptr, st, l, dl, shape, s); break;
    case kWgmma * 256 + 64:
    case kWgmma * 256 + 128:
      err = launch_bwd_wgmma(ptr, st, l, shape, d, s);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory (bytes) a block of the wgmma kernel takes for
// the forward (which 0) or backward (1) of a call, and the blocks one SM holds (`blocks`), so the
// wrapper's plan can be held to the kernels' own numbers; 0 where the
// wgmma kernel does not take the call.
extern "C" long long ks_short_attention_footprint(int which, int d, int nq, int nk, int* blocks) {
  long long smem = 0;
  *blocks = 0;
  if (takes(kWgmma, true, d, nq, nk))
    wgmma_footprint(which, d, nq, nk, &smem, blocks);
  return smem;
}

