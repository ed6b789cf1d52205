// Non-causal flash attention on (B, H, N, D) tensors: forward (out, lse) and
// the backward's two kernels, dq and dk/dv, from the caller's lse and delta.
// The long-sequence attention of the zoo: a whole-scene ViT encode attends
// over every patch token of the scene at once (4,096 for a 1024x1024 scene).
//
// Replaces the TPU kernels kurosiwo_tpu/ops/pallas_attention.py::_fwd_kernel
// (:33, launched by _flash_fwd, :116, pallas_call :124), _dq_kernel (:63) and
// _dkv_kernel (:86), both launched by flash_bwd (:177, pallas_calls :189 and
// :205). As there, delta = sum_d(do * out) is the caller's: a ring pass
// (ROADMAP A12) hands each rotating k/v block the global lse and delta.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): operations. At
// the whole-scene call (1, 16, 4096, 64) bf16 the forward's two products are
// 68.7 GFLOP, 69 us on the tensor cores, while q, k, v, out and lse are
// 33.8 MB, 10 us; its 268 M exponentials take about 65 us on the SFUs
// (132 SMs x 16 a clock), nearly as long. The backward's five products
// (172 GFLOP) need 174 us; the split into a dq and a dk/dv kernel executes
// seven (both recompute the scores and dp), 243 us.
//
// The TPU kernel keeps a (512, D) query block in VMEM and streams (1024, D)
// key blocks through the Pallas pipeline; the card wants many blocks of its
// own instead. Three families of kernels; the wrapper's plan
// (ops/flash_attention.py: flash_plan) names one for each call and the entry
// points refuse a call the named kernel does not take:
//  * wgmma (bf16, D 64 and 128: the serving path). Blocks of three
//    warpgroups: two consumers of 64 rows each and a producer whose one
//    thread keeps TMA copies in flight (hopper.cuh), completion counted on
//    one mbarrier a stage, freed by an mbarrier the consumers arrive at;
//    setmaxnreg moves registers from the producer to the consumers. Every
//    tensor is read through a rank-4 tensor map over its (B, H, N, D) view
//    with the view's own strides, so the column-thirds of a packed
//    (B, N, 3*H*D) qkv projection go in with no copy, and rows past N read
//    as 0 (never the next head's). Products are wgmma on B128 tiles: Q, K,
//    V, dO as they lie (D contiguous) are K-major operands of the score
//    products and MN-major B operands (transpose bit) of the value and
//    gradient products; p and ds never leave registers, as the A operand of
//    the RS form. Outputs go straight from registers into their views.
//     - forward (hw::flash_fwd): 128 query rows a block (512 blocks, 3.9
//       waves of the 132 SMs at the scene's shape), 128-key K and V tiles
//       on a two-stage ring with separate K and V barriers. S = Q K^T
//       (m64n128k16 SS), an online softmax in base 2 on the f32 scores
//       (scale * log2(e) folded in, one ex2 a score, -inf past Nk on a
//       ragged last tile), O += P V (RS). The exponentials overlap the
//       products twice: each warpgroup issues tile t's S with tile t - 1's
//       P V and runs t's softmax while they execute, and the two
//       warpgroups take turns issuing (named barriers), so one's softmax
//       runs under the other's products. lse is returned in natural log.
//     - dk/dv (hw::flash_dkv): 128 keys a block; 64-row Q and dO tiles with
//       their lse and delta stream through a ring of 4 stages (the producer
//       warp writes lse (+inf past Nq, so p = 0 there) and delta beside each
//       TMA pair). S^T = K Q^T and dP^T = V dO^T (m64n64k16; at D 64 with K
//       and V as register A fragments, loaded once by ldmatrix, at D 128
//       SS), then dV += P^T dO and dK += dS^T Q (RS).
//     - dq (hw::flash_dq): 128 queries a block; 64-key K and V tiles on a
//       ring of 4 stages. S = Q K^T and dP = dO V^T (SS), dQ += dS K (RS);
//       p = 0 past Nk on a ragged last tile.
//  * mma_sync (bf16, D 32): mma.sync m16n8k16 tensor-core products with
//    f32 accumulators, 4 warps of 16 rows on 64-row tiles, through the tile
//    helpers of attention_tiles.cuh that B4 uses too; K/V (or Q/dO) tiles of
//    64 rows on a two-stage cp.async ring.
//  * simt (f32, the parity path): CUDA-core FMA on f32 tiles, 256 threads, a
//    4x4 register tile of the 64x64 scores each; p and ds stay f32, as on
//    the TPU.
// The TPU kernel keeps p and ds in f32 through its products; the bf16
// kernels round them to bf16 as the next product's A operand: the one
// numerical deviation. Deterministic, no float atomics: dk/dv accumulate
// over query tiles in one kernel, dq over key tiles in another, each in a
// fixed order.
#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

template <typename T>
struct View {  // element (b, h, n, d) at p[b * sb + h * sh + n * sn + d]
  T* p;
  long long sb, sh, sn;
  __device__ __forceinline__ T* at(int b, int h) const { return p + b * sb + h * sh; }
};

// ===================================================================== f32

namespace simt {

// rows [r0, r0 + 64) of an (N, D) slab with row stride sn into a [64][D + 1]
// tile; rows at or past n are zero
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sn, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? src[row * sn + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long sn, int r0, int n,
                                           const float (&acc)[4][D / 16], const float (&div)[4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dst[row * sn + tx + 16 * c] = acc[r][c] / div[r];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(View<const float> q, View<const float> k, View<const float> v, View<float> o,
          float* __restrict__ lse, int heads, int nq, int nk, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* kts = qs + kTile * (D + 1);
  float* vs = kts + kTile * (D + 1);
  float* ps = vs + kTile * (D + 1);
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = k.at(b, h);
  const float* vb = v.at(b, h);

  load_rows<D>(qs, q.at(b, h), q.sn, q0, nq);
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
    load_rows<D>(kts, kb, k.sn, k0, nk);
    load_rows<D>(vs, vb, v.sn, k0, nk);
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
      // every tile holds a valid key, so m_new is finite
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
  store_rows<D>(o.at(b, h), o.sn, q0, nq, acc, l);
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
flash_dkv(View<const float> q, View<const float> k, View<const float> v, View<const float> dout,
          const float* __restrict__ lse, const float* __restrict__ delta, View<float> dk,
          View<float> dv, int heads, int nq, int nk, float scale) {
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
  const float* qb = q.at(b, h);
  const float* dob = dout.at(b, h);

  load_rows<D>(kts, k.at(b, h), k.sn, k0, nk);
  load_rows<D>(vs, v.at(b, h), v.sn, k0, nk);
  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[r][c] = dva[r][c] = 0.f;
  for (int q0 = 0; q0 < nq; q0 += kTile) {
    __syncthreads();
    load_rows<D>(qs, qb, q.sn, q0, nq);
    load_rows<D>(dos, dob, dout.sn, q0, nq);
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
  store_rows<D>(dk.at(b, h), dk.sn, k0, nk, dka, one);
  store_rows<D>(dv.at(b, h), dv.sn, k0, nk, dva, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq(View<const float> q, View<const float> k, View<const float> v, View<const float> dout,
         const float* __restrict__ lse, const float* __restrict__ delta, View<float> dq,
         int heads, int nq, int nk, float scale) {
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
  const float* kb = k.at(b, h);
  const float* vb = v.at(b, h);

  load_rows<D>(qs, q.at(b, h), q.sn, q0, nq);
  load_rows<D>(dos, dout.at(b, h), dout.sn, q0, nq);
  load_row_stats(ls, dl, lse, delta, bh, q0, nq);
  float dqa[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[r][c] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_rows<D>(kts, kb, k.sn, k0, nk);
    load_rows<D>(vs, vb, v.sn, k0, nk);
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
  store_rows<D>(dq.at(b, h), dq.sn, q0, nq, dqa, one);
}

constexpr size_t tile_bytes(int d) { return sizeof(float) * kTile * (d + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kLdS; }
constexpr size_t fwd_smem(int d) { return 3 * tile_bytes(d) + score_bytes(); }
constexpr size_t dkv_smem(int d) {
  return 4 * tile_bytes(d) + 2 * score_bytes() + 2 * kTile * sizeof(float);
}
constexpr size_t dq_smem(int d) {
  return 4 * tile_bytes(d) + score_bytes() + 2 * kTile * sizeof(float);
}

}  // namespace simt

// ===================================================================== bf16

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies that bypass registers; when !valid the bytes are
// zero-filled and the source is not read
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most one of this thread's committed groups is in flight
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int D>
constexpr int kElems = kTile * (D + 8);  // a [64][D + 8] bf16 tile

// rows [r0, r0 + 64) of an (N, D) slab with row stride sn into a [64][D + 8]
// tile in 16-byte copies (the wrapper checks their alignment); rows at or
// past n are zero-filled, their source never read
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long sn, int r0,
                                          int n) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8, row = r0 + r;
    const bool in = row < n;
    copy16(dst + r * (D + 8) + c, src + (in ? row : 0) * sn + c, in);
  }
}

// lse and delta of query rows [q0, q0 + 64) of one (batch, head), whose
// rows start at offset `first`; zero past nq
__device__ __forceinline__ void copy_row_stats(float* ls, float* dl, const float* lse,
                                               const float* delta, long long first, int q0,
                                               int nq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = q0 + r;
    const bool in = row < nq;
    const long long i = first + (in ? row : 0);
    copy4(ls + r, lse + i, in);
    copy4(dl + r, delta + i, in);
  }
}

// this warp's 16 rows of a 16 x D accumulator block, divided by the row's
// divisor, into bf16 rows with row stride sn
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long sn, int row0, int n,
                                           const float (&acc)[D / 8][4], const float (&div)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lane / 4 + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + row * sn + 8 * dt + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc[dt][2 * half] / div[half], acc[dt][2 * half + 1] / div[half]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one SFU op; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of the forward for this warp's 16 query rows: scores from the
// query fragments held in registers, online-softmax update in base 2 (m is
// the running max of s * scale_log2), acc += p v. kRagged masks the keys at
// or past `valid` (the last tile of a ragged Nk); full tiles skip the test.
template <int D, bool kRagged>
__device__ __forceinline__ void fwd_tile(float (&acc)[D / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qf)[D / 16][4], const bf16* kt,
                                         const bf16* vt, int valid, float scale_log2) {
  const int lane = threadIdx.x & 31;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) scores_step<D>(s, qf[ks], kt, ks);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kRagged && 8 * nt + (lane % 4) * 2 + (e & 1) >= valid) s[nt][e] = -INFINITY;
      mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    }
  float alpha[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // finite: every tile holds a valid key, and scale_log2 > 0
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];  // this lane's share of the row sum, reduced at the end
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ex2(fmaf(s[nt][e], scale_log2, neg_m[e / 2]));
      l[e / 2] += s[nt][e];
    }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
  accumulate<D>(acc, s, vt);  // masked keys have p = 0 and v = 0
}

// scale_log2 = scale * log2(e): the running max m and the exponents are in
// base 2, so p = exp2(s * scale_log2 - m) = exp(s * scale - m ln 2)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<bf16> o,
          float* __restrict__ lse, int heads, int nq, int nk, float scale_log2) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* kts = qs + kElems<D>;      // two stages
  bf16* vs = kts + 2 * kElems<D>;  // two stages
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x / 32);
  const bf16* kb = k.at(b, h);
  const bf16* vb = v.at(b, h);
  const int tiles = (nk + kTile - 1) / kTile;

  copy_rows<D>(qs, q.at(b, h), q.sn, q0, nq);
  commit();
  copy_rows<D>(kts, kb, k.sn, 0, nk);
  copy_rows<D>(vs, vb, v.sn, 0, nk);
  commit();
  wait_all_but_one();  // the query tile has landed
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments, for every tile
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a(qf[ks], qs, D + 8, r0, 16 * ks);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows lane/4 and lane/4 + 8
  float acc[D / 8][4];
  zero<D>(acc);
  for (int t = 0; t < tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < tiles) {
      copy_rows<D>(kts + (stage ^ 1) * kElems<D>, kb, k.sn, (t + 1) * kTile, nk);
      copy_rows<D>(vs + (stage ^ 1) * kElems<D>, vb, v.sn, (t + 1) * kTile, nk);
    }
    commit();  // empty on the last tile: the group count stays uniform
    wait_all_but_one();  // tile t has landed
    __syncthreads();
    const bf16* kt = kts + stage * kElems<D>;
    const bf16* vt = vs + stage * kElems<D>;
    const int valid = nk - t * kTile;
    if (valid >= kTile)
      fwd_tile<D, false>(acc, m, l, qf, kt, vt, valid, scale_log2);
    else
      fwd_tile<D, true>(acc, m, l, qf, kt, vt, valid, scale_log2);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_rows<D>(o.at(b, h), o.sn, q0 + r0, nq, acc, l);
  if (lane % 4 == 0) {
    constexpr float kLn2 = 0.693147180559945309f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + lane / 4 + 8 * half;
      if (row < nq) lse[static_cast<long long>(bh) * nq + row] = m[half] * kLn2 + logf(l[half]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<const bf16> dout,
          const float* __restrict__ lse, const float* __restrict__ delta, View<bf16> dk,
          View<bf16> dv, int heads, int nq, int nk, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* kts = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = kts + kElems<D>;
  bf16* qs = vs + kElems<D>;        // two stages
  bf16* dos = qs + 2 * kElems<D>;   // two stages
  float* ls = reinterpret_cast<float*>(dos + 2 * kElems<D>);  // two stages of 64
  float* dl = ls + 2 * kTile;                                 // two stages of 64
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x / 32);
  const bool key_in[2] = {k0 + r0 + lane / 4 < nk, k0 + r0 + lane / 4 + 8 < nk};
  const bf16* qb = q.at(b, h);
  const bf16* dob = dout.at(b, h);
  const long long first = static_cast<long long>(bh) * nq;
  const int tiles = (nq + kTile - 1) / kTile;

  copy_rows<D>(kts, k.at(b, h), k.sn, k0, nk);
  copy_rows<D>(vs, v.at(b, h), v.sn, k0, nk);
  copy_rows<D>(qs, qb, q.sn, 0, nq);
  copy_rows<D>(dos, dob, dout.sn, 0, nq);
  copy_row_stats(ls, dl, lse, delta, first, 0, nq);
  commit();
  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);
  for (int t = 0; t < tiles; ++t) {
    const int stage = t & 1, next = stage ^ 1;
    if (t + 1 < tiles) {
      const int q1 = (t + 1) * kTile;
      copy_rows<D>(qs + next * kElems<D>, qb, q.sn, q1, nq);
      copy_rows<D>(dos + next * kElems<D>, dob, dout.sn, q1, nq);
      copy_row_stats(ls + next * kTile, dl + next * kTile, lse, delta, first, q1, nq);
    }
    commit();
    wait_all_but_one();
    __syncthreads();
    const bf16* qt = qs + stage * kElems<D>;
    const bf16* dot = dos + stage * kElems<D>;
    const float* lst = ls + stage * kTile;
    const float* dlt = dl + stage * kTile;
    const int q0 = t * kTile;
    // rows: this warp's 16 keys; columns: the tile's 64 queries
    float pt[8][4], dst[8][4];
    scores<D>(pt, kts, r0, qt);
    scores<D>(dst, vs, r0, dot);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + (lane % 4) * 2 + (e & 1);
        const float p = key_in[e / 2] && q0 + i < nq ? expf(scale * pt[nt][e] - lst[i]) : 0.f;
        dst[nt][e] = p * (dst[nt][e] - dlt[i]) * scale;
        pt[nt][e] = p;
      }
    accumulate<D>(dva, pt, dot);  // dV += P^T dO, p rounded to bf16
    accumulate<D>(dka, dst, qt);  // dK += dS^T Q, ds rounded to bf16
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk.at(b, h), dk.sn, k0 + r0, nk, dka, one);
  store_rows<D>(dv.at(b, h), dv.sn, k0 + r0, nk, dva, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq(View<const bf16> q, View<const bf16> k, View<const bf16> v, View<const bf16> dout,
         const float* __restrict__ lse, const float* __restrict__ delta, View<bf16> dq,
         int heads, int nq, int nk, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + kElems<D>;
  bf16* kts = dos + kElems<D>;      // two stages
  bf16* vs = kts + 2 * kElems<D>;   // two stages
  float* ls = reinterpret_cast<float*>(vs + 2 * kElems<D>);
  float* dl = ls + kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x / 32);
  const bf16* kb = k.at(b, h);
  const bf16* vb = v.at(b, h);
  const int tiles = (nk + kTile - 1) / kTile;

  copy_rows<D>(qs, q.at(b, h), q.sn, q0, nq);
  copy_rows<D>(dos, dout.at(b, h), dout.sn, q0, nq);
  copy_rows<D>(kts, kb, k.sn, 0, nk);
  copy_rows<D>(vs, vb, v.sn, 0, nk);
  copy_row_stats(ls, dl, lse, delta, static_cast<long long>(bh) * nq, q0, nq);
  commit();
  const int i0 = r0 + lane / 4;
  const bool query_in[2] = {q0 + i0 < nq, q0 + i0 + 8 < nq};
  float dqa[D / 8][4];
  zero<D>(dqa);
  for (int t = 0; t < tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < tiles) {
      copy_rows<D>(kts + (stage ^ 1) * kElems<D>, kb, k.sn, (t + 1) * kTile, nk);
      copy_rows<D>(vs + (stage ^ 1) * kElems<D>, vb, v.sn, (t + 1) * kTile, nk);
    }
    commit();
    wait_all_but_one();
    __syncthreads();
    const bf16* kt = kts + stage * kElems<D>;
    const float row_lse[2] = {ls[i0], ls[i0 + 8]}, row_delta[2] = {dl[i0], dl[i0 + 8]};
    const int k0 = t * kTile;
    // rows: this warp's 16 queries; columns: the tile's 64 keys
    float s[8][4], dp[8][4];
    scores<D>(s, qs, r0, kt);
    scores<D>(dp, dos, r0, vs + stage * kElems<D>);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 8 * nt + (lane % 4) * 2 + (e & 1);
        const float p =
            query_in[e / 2] && j < nk ? expf(scale * s[nt][e] - row_lse[e / 2]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[e / 2]) * scale;
      }
    accumulate<D>(dqa, s, kt);  // dQ += dS K, ds rounded to bf16
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq.at(b, h), dq.sn, q0 + r0, nq, dqa, one);
}

constexpr size_t tile_bytes(int d) { return sizeof(bf16) * kTile * (d + 8); }
constexpr size_t fwd_smem(int d) { return 5 * tile_bytes(d); }
constexpr size_t dq_smem(int d) { return 6 * tile_bytes(d) + 2 * kTile * sizeof(float); }
constexpr size_t dkv_smem(int d) { return 6 * tile_bytes(d) + 4 * kTile * sizeof(float); }

}  // namespace tc

// ============================================================ bf16, wgmma

namespace hw {

using hopper::bar_arrive;
using hopper::bar_sync;
using hopper::desc_b128;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kRows = 128;      // a block's own rows: queries (forward, dq) or keys (dk/dv)
constexpr int kFwdKeys = 128;   // rows of a forward K or V tile
constexpr int kBwdRows = 64;    // rows of a streamed backward tile: keys (dq), queries (dk/dv)
constexpr int kBwdStages = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 64 K

// A [rows][D] bf16 tile is D / 64 column blocks of rows x 128 bytes (B128
// tiles, 1024-byte aligned): what one box per column block of a heads map
// writes.
__host__ __device__ constexpr uint32_t tile_bytes(int rows, int d) { return rows * d * 2; }

// the rows rows .. rows + `rows` of one (batch, head) into the tile at dst
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, int row, int h,
                                          int b, int rows, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * rows * 128, map, 64 * c, row, h, b, bar);
}

// K-major operand (A, or B with N along the rows): rows r0 .. r0 + 64 (A)
// or all `rows` (B) of a [rows][D] tile, its k16 step kk along D
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0, int kk) {
  return desc_b128(tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32, rows * 128, 1024);
}

// MN-major B (K along the rows, N = D along the row): k16 step kk of a
// [rows][D] tile
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return desc_b128(tile + kk * 2048, rows * 128, 1024);
}

// acc (64 x N) += A (64 x 16, registers) B (16 x N; MN-major for TB = 1,
// K-major for 0) for N 64 / 128; scale_d = 0 overwrites acc
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d = 1) {
  if constexpr (N == 64)
    hopper::wgmma_m64n64k16_rs<TB>(acc, a, b, scale_d);
  else
    hopper::wgmma_m64n128k16_rs<TB>(acc, a, b, scale_d);
}

// A fragments (the k16 steps of D) of this warp's 16 of rows r0 .. r0 + 64 of
// a [rows][D] B128 tile, by ldmatrix through the 128-byte swizzle
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], uint32_t tile, int rows,
                                             int r0) {
  const int lane = threadIdx.x & 31, mat = lane / 8;
  const int row = r0 + 16 * ((threadIdx.x / 32) % 4) + (mat & 1) * 8 + lane % 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = 2 * (kk % 4) + (mat >> 1);
    const uint32_t addr = tile + (kk / 4) * rows * 128 + row * 128 + ((chunk ^ (row & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// this thread's rows of a warpgroup's 64 x D accumulator (rows r and r + 8,
// r = 16 * warp + lane / 4 from `row0`), divided by the row's divisor, into
// bf16 rows with row stride sn; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, long long sn, int row0, int n,
                                          const float (&acc)[D / 2], const float (&div)[2]) {
  const int lane = threadIdx.x & 31, r = row0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= n) continue;
    bf16* out = dst + (r + 8 * h) * sn + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / div[h], acc[4 * j + 2 * h + 1] / div[h]);
  }
}

// ------------------------------------------------------------- forward

template <int D>
struct FwdLayout {
  static constexpr int kStages = 2;
  static constexpr uint32_t kQ = tile_bytes(kRows, D), kKV = tile_bytes(kFwdKeys, D);
  static constexpr uint32_t q = 0, k = kQ, v = k + kStages * kKV, bars = v + kStages * kKV;
  // barriers: Q; per stage full K, full V, empty K, empty V
  static constexpr uint32_t full_k = bars + 8, full_v = full_k + 8 * kStages,
                            empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;
  static constexpr uint32_t bytes = empty_v + 8 * kStages + 1024;  // + alignment slack
};

// scale_log2 = scale * log2(e): the running max m and the exponents are in
// base 2, so p = exp2(s * scale_log2 - m) = exp(s * scale - m ln 2)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, View<bf16> o, float* __restrict__ lse,
          int heads, int nq, int nk, float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023) & ~1023u;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, q0 = blockIdx.x * kRows;
  const int tiles = (nk + kFwdKeys - 1) / kFwdKeys;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(base + L::bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(base + L::full_k + 8 * s, 1);
      mbar_init(base + L::full_v + 8 * s, 1);
      mbar_init(base + L::empty_k + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(base + L::empty_v + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every copy
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(base + L::bars, L::kQ);
      load_tile<D>(base + L::q, qmap, q0, h, b, kRows, base + L::bars);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        const uint32_t free_phase = ((j / S) & 1) ^ 1;
        mbar_wait(base + L::empty_k + 8 * s, free_phase);
        mbar_arrive_expect_tx(base + L::full_k + 8 * s, L::kKV);
        load_tile<D>(base + L::k + s * L::kKV, kmap, j * kFwdKeys, h, b, kFwdKeys,
                     base + L::full_k + 8 * s);
        mbar_wait(base + L::empty_v + 8 * s, free_phase);
        mbar_arrive_expect_tx(base + L::full_v + 8 * s, L::kKV);
        load_tile<D>(base + L::v + s * L::kKV, vmap, j * kFwdKeys, h, b, kFwdKeys,
                     base + L::full_v + 8 * s);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 64
    hopper::regs_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31;
    float s[64], acc[D / 2];
    uint32_t p[8][4];  // P as A fragments: step kk holds keys 16 kk .. 16 kk + 16
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
    zero(s);
    zero(acc);
    // The warpgroups take turns issuing their products: each waits at its
    // own named barrier (1 + wg) and, once its products are issued, lets
    // the other one go; warpgroup 0 starts. Warpgroup 1 skips its last
    // release, so every arrival meets a wait.
    if (wg == 0) bar_arrive(1, 256);
    auto my_turn = [&]() { bar_sync(1 + wg, 256); };
    auto your_turn = [&](bool last) {
      if (!(last && wg == 1)) bar_arrive(2 - wg, 256);
    };
    auto issue_s = [&](int st) {  // s = Q K^T over D
      const uint32_t kt = base + L::k + st * L::kKV;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n128k16<0, 0>(s, kmajor(base + L::q, kRows, 64 * wg, kk),
                                       kmajor(kt, kFwdKeys, 0, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {  // acc += P V over the tile's 128 keys
      const uint32_t vt = base + L::v + st * L::kKV;
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) wgmma_rs<D>(acc, p[kk], mnmajor(vt, kFwdKeys, kk));
      wgmma_commit();
    };
    // online softmax of the scores of one tile, `valid` of its keys real:
    // s becomes p, alpha the factor of the earlier rows' sums
    auto softmax = [&](int valid) {
      if (valid < kFwdKeys) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= valid) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
      float neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // finite: every tile holds a valid key, and scale_log2 > 0
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
        alpha[r] = tc::ex2(m[r] - m_new);
        m[r] = m_new;
        neg_m[r] = -m_new;
        l[r] *= alpha[r];  // this lane's share of the row sum, reduced at the end
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = tc::ex2(fmaf(s[i], scale_log2, neg_m[(i / 2) & 1]));
        l[(i / 2) & 1] += s[i];
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) & 1];
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(base + L::bars, 0);
    mbar_wait(base + L::full_k, 0);
    my_turn();
    issue_s(0);
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(s);
    release(base + L::empty_k);
    softmax(nk);
    hopper::accumulator_as_a<128>(p, s);
    for (int t = 1; t < tiles; ++t) {
      const int st = t % S, pst = (t - 1) % S;
      mbar_wait(base + L::full_k + 8 * st, (t / S) & 1);
      my_turn();
      issue_s(st);
      rescale();  // by tile t - 1's alpha, before its P V is added
      mbar_wait(base + L::full_v + 8 * pst, ((t - 1) / S) & 1);
      issue_pv(pst);
      your_turn(false);
      wgmma_wait<1>();  // S of tile t has landed; P V of tile t - 1 may still run
      fence_regs(s);
      release(base + L::empty_k + 8 * st);
      softmax(nk - t * kFwdKeys);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      release(base + L::empty_v + 8 * pst);
      hopper::accumulator_as_a<128>(p, s);
    }
    rescale();
    const int lst = (tiles - 1) % S;
    mbar_wait(base + L::full_v + 8 * lst, ((tiles - 1) / S) & 1);
    my_turn();
    issue_pv(lst);
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(acc);

    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    store_acc<D>(o.at(b, h), o.sn, q0 + 64 * wg, nq, acc, l);
    if (lane % 4 == 0) {
      constexpr float kLn2 = 0.693147180559945309f;
      const int r = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (r + 8 * hh < nq)
          lse[static_cast<long long>(bh) * nq + r + 8 * hh] = m[hh] * kLn2 + logf(l[hh]);
    }
  }
}

// ------------------------------------------------------------- backward

template <int D>
struct DqLayout {
  static constexpr int kStages = kBwdStages;
  static constexpr uint32_t kOwn = tile_bytes(kRows, D), kTile = tile_bytes(kBwdRows, D);
  static constexpr uint32_t q = 0, dout = kOwn, k = 2 * kOwn, v = k + kStages * kTile,
                            bars = v + kStages * kTile;
  // barriers: Q and dO; per stage full (K and V), empty
  static constexpr uint32_t full = bars + 8, empty = full + 8 * kStages;
  static constexpr uint32_t bytes = empty + 8 * kStages + 1024;
};

template <int D>
struct DkvLayout {
  static constexpr int kStages = kBwdStages;
  static constexpr uint32_t kOwn = tile_bytes(kRows, D), kTile = tile_bytes(kBwdRows, D);
  static constexpr uint32_t kStats = 2 * kBwdRows * 4;  // lse * log2(e), then delta, f32
  static constexpr uint32_t k = 0, v = kOwn, q = 2 * kOwn, dout = q + kStages * kTile,
                            stats = dout + kStages * kTile, bars = stats + kStages * kStats;
  // barriers: K and V; per stage full (Q, dO, lse and delta), empty
  static constexpr uint32_t full = bars + 8, empty = full + 8 * kStages;
  static constexpr uint32_t bytes = empty + 8 * kStages + 1024;
};

// the k16 steps of p (or ds) as A fragments: 64 x 64 f32 accumulator
using Frag64 = uint32_t[4][4];

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
         const float* __restrict__ lse, const float* __restrict__ delta, View<bf16> dq,
         int heads, int nq, int nk, float scale) {
  using L = DqLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023) & ~1023u;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, q0 = blockIdx.x * kRows;
  const int tiles = (nk + kBwdRows - 1) / kBwdRows;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(base + L::bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(base + L::full + 8 * s, 1);
      mbar_init(base + L::empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(base + L::bars, 2 * L::kOwn);
      load_tile<D>(base + L::q, qmap, q0, h, b, kRows, base + L::bars);
      load_tile<D>(base + L::dout, domap, q0, h, b, kRows, base + L::bars);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        const uint32_t full = base + L::full + 8 * s;
        mbar_wait(base + L::empty + 8 * s, ((j / S) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 2 * L::kTile);
        load_tile<D>(base + L::k + s * L::kTile, kmap, j * kBwdRows, h, b, kBwdRows, full);
        load_tile<D>(base + L::v + s * L::kTile, vmap, j * kBwdRows, h, b, kBwdRows, full);
      }
    }
  } else {  // warpgroup wg owns query rows 64 wg .. 64 wg + 64
    hopper::regs_inc<kConsumerRegs>();
    constexpr float kLog2e = 1.44269504088896341f;
    const int lane = threadIdx.x & 31;
    const int r = q0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    const float scale_log2 = scale * kLog2e;
    float ls[2], dl[2];  // lse * log2(e) and delta of rows r and r + 8 (0 past nq)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool in = r + 8 * hh < nq;
      const long long i = static_cast<long long>(bh) * nq + r + 8 * hh;
      ls[hh] = in ? lse[i] * kLog2e : 0.f;
      dl[hh] = in ? delta[i] : 0.f;
    }
    float s[32], dp[32], acc[D / 2];
    Frag64 ds;
    zero(s);
    zero(dp);
    zero(acc);
    mbar_wait(base + L::bars, 0);
    for (int t = 0; t < tiles; ++t) {
      const int st = t % S;
      const uint32_t kt = base + L::k + st * L::kTile, vt = base + L::v + st * L::kTile;
      mbar_wait(base + L::full + 8 * st, (t / S) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16<0, 0>(s, kmajor(base + L::q, kRows, 64 * wg, kk),
                                      kmajor(kt, kBwdRows, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16<0, 0>(dp, kmajor(base + L::dout, kRows, 64 * wg, kk),
                                      kmajor(vt, kBwdRows, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const int valid = nk - t * kBwdRows;  // keys past nk: p = 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float p = tc::ex2(fmaf(s[i], scale_log2, -ls[(i / 2) & 1]));
        if (valid < kBwdRows && 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= valid) p = 0.f;
        s[i] = p * (dp[i] - dl[(i / 2) & 1]) * scale;
      }
      hopper::accumulator_as_a<64>(ds, s);
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdRows / 16; ++kk)
        wgmma_rs<D>(acc, ds[kk], mnmajor(kt, kBwdRows, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(base + L::empty + 8 * st);
    }
    const float one[2] = {1.f, 1.f};
    store_acc<D>(dq.at(b, h), dq.sn, q0 + 64 * wg, nq, acc, one);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
          const float* __restrict__ lse, const float* __restrict__ delta, View<bf16> dk,
          View<bf16> dv, int heads, int nq, int nk, float scale) {
  using L = DkvLayout<D>;
  constexpr int S = L::kStages;
  constexpr float kLog2e = 1.44269504088896341f;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = hopper::smem_addr(wg_smem), base = (raw + 1023) & ~1023u;
  float* stats = reinterpret_cast<float*>(wg_smem + (base - raw) + L::stats);
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads, k0 = blockIdx.x * kRows;
  const int tiles = (nq + kBwdRows - 1) / kBwdRows;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(base + L::bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(base + L::full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(base + L::empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // producer warp: lane 0 issues the copies, every lane stages lse and delta
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < 288) {
      if (lane == 0) {
        mbar_arrive_expect_tx(base + L::bars, 2 * L::kOwn);
        load_tile<D>(base + L::k, kmap, k0, h, b, kRows, base + L::bars);
        load_tile<D>(base + L::v, vmap, k0, h, b, kRows, base + L::bars);
      }
      const long long first = static_cast<long long>(bh) * nq;
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S;
        const uint32_t full = base + L::full + 8 * s;
        mbar_wait(base + L::empty + 8 * s, ((j / S) & 1) ^ 1);
        float* st = stats + s * 2 * kBwdRows;
#pragma unroll
        for (int i = lane; i < kBwdRows; i += 32) {
          const int row = j * kBwdRows + i;
          const bool in = row < nq;
          st[i] = in ? lse[first + row] * kLog2e : INFINITY;  // p = 0 past nq
          st[kBwdRows + i] = in ? delta[first + row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * L::kTile);
          load_tile<D>(base + L::q + s * L::kTile, qmap, j * kBwdRows, h, b, kBwdRows, full);
          load_tile<D>(base + L::dout + s * L::kTile, domap, j * kBwdRows, h, b, kBwdRows, full);
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {  // warpgroup wg owns keys 64 wg .. 64 wg + 64
    hopper::regs_inc<kConsumerRegs>();
    const float scale_log2 = scale * kLog2e;
    float s[32], dp[32], dka[D / 2], dva[D / 2];
    Frag64 pa, da;
    zero(s);
    zero(dp);
    zero(dka);
    zero(dva);
    // At D 64 the warpgroup's K and V rows are A fragments in registers,
    // loaded once: S^T and dP^T then read only Q and dO from shared memory
    // (m64n64k16 with both operands there is at its 128 bytes a clock). At
    // D 128 the registers are not there.
    constexpr bool kOwnRegs = D == 64;
    uint32_t ka[kOwnRegs ? D / 16 : 1][4], va[kOwnRegs ? D / 16 : 1][4];
    mbar_wait(base + L::bars, 0);
    if constexpr (kOwnRegs) {
      load_a_frags<D>(ka, base + L::k, kRows, 64 * wg);
      load_a_frags<D>(va, base + L::v, kRows, 64 * wg);
      fence_regs(ka);
      fence_regs(va);
    }
    for (int t = 0; t < tiles; ++t) {
      const int st = t % S;
      const uint32_t qt = base + L::q + st * L::kTile, dot = base + L::dout + st * L::kTile;
      const float* ls = stats + st * 2 * kBwdRows;
      mbar_wait(base + L::full + 8 * st, (t / S) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      // rows: this warpgroup's keys; columns: the tile's 64 queries
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (kOwnRegs)
          wgmma_rs<64, 0>(s, ka[kk], kmajor(qt, kBwdRows, 0, kk), kk > 0);
        else
          hopper::wgmma_m64n64k16<0, 0>(s, kmajor(base + L::k, kRows, 64 * wg, kk),
                                        kmajor(qt, kBwdRows, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (kOwnRegs)
          wgmma_rs<64, 0>(dp, va[kk], kmajor(dot, kBwdRows, 0, kk), kk > 0);
        else
          hopper::wgmma_m64n64k16<0, 0>(dp, kmajor(base + L::v, kRows, 64 * wg, kk),
                                        kmajor(dot, kBwdRows, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + kBwdRows + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float p = tc::ex2(fmaf(s[i], scale_log2, -(e & 1 ? l2.y : l2.x)));
          s[i] = p;
          dp[i] = p * (dp[i] - (e & 1 ? d2.y : d2.x)) * scale;
        }
      }
      hopper::accumulator_as_a<64>(pa, s);
      hopper::accumulator_as_a<64>(da, dp);
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdRows / 16; ++kk)
        wgmma_rs<D>(dva, pa[kk], mnmajor(dot, kBwdRows, kk));
#pragma unroll
      for (int kk = 0; kk < kBwdRows / 16; ++kk)
        wgmma_rs<D>(dka, da[kk], mnmajor(qt, kBwdRows, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(base + L::empty + 8 * st);
    }
    const float one[2] = {1.f, 1.f};
    store_acc<D>(dk.at(b, h), dk.sn, k0 + 64 * wg, nk, dka, one);
    store_acc<D>(dv.at(b, h), dv.sn, k0 + 64 * wg, nk, dva, one);
  }
}

}  // namespace hw

// ===================================================================== host

template <typename T>
View<const T> in_view(const void* p, const long long* st) {
  return {static_cast<const T*>(p), st[0], st[1], st[2]};
}
template <typename T>
View<T> out_view(void* p, const long long* st) {
  return {static_cast<T*>(p), st[0], st[1], st[2]};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Shape {
  int batch, heads, nq, nk;
  float scale;
  dim3 grid(int n, int rows = kTile) const { return dim3((n + rows - 1) / rows, batch * heads); }
};

constexpr float kLog2e = 1.44269504088896341f;

// The kernels; the wrapper's plan (ops/flash_attention.py: flash_plan) names
// one of them for each call.
enum Kernel { kSimt = 0, kMmaSync = 1, kWgmma = 2 };

// whether `kernel` computes a call of this dtype and head size: the one
// check of the plan
bool takes(int kernel, bool bf16, int d) {
  switch (kernel) {
    case kSimt: return !bf16 && (d == 32 || d == 64 || d == 128);
    case kMmaSync: return bf16 && d == 32;
    case kWgmma: return bf16 && (d == 64 || d == 128);
    default: return false;
  }
}

// the rank-4 tensor map of operand i (pointer ptr[i], strides st[3 i ..]),
// n rows, in boxes of `rows` rows
template <int D>
bool heads_map(CUtensorMap* map, void* const* ptr, const long long* st, int i, const Shape& s,
               int n, int rows) {
  return hopper::encode_bf16_heads(map, ptr[i], s.batch, s.heads, n, D, st[3 * i],
                                   st[3 * i + 1], st[3 * i + 2], rows) == 0;
}

template <int D>
cudaError_t fwd_f32(void* const* ptr, const long long* st, float* lse, Shape s,
                    cudaStream_t stream) {
  const size_t smem = simt::fwd_smem(D);
  cudaError_t err = allow_smem(simt::flash_fwd<D>, smem);
  if (err != cudaSuccess) return err;
  simt::flash_fwd<D><<<s.grid(s.nq), simt::kThreads, smem, stream>>>(
      in_view<float>(ptr[0], st), in_view<float>(ptr[1], st + 3), in_view<float>(ptr[2], st + 6),
      out_view<float>(ptr[3], st + 9), lse, s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_mma_sync(void* const* ptr, const long long* st, float* lse, Shape s,
                         cudaStream_t stream) {
  const size_t smem = tc::fwd_smem(D);
  cudaError_t err = allow_smem(tc::flash_fwd<D>, smem);
  if (err != cudaSuccess) return err;
  tc::flash_fwd<D><<<s.grid(s.nq), tc::kThreads, smem, stream>>>(
      in_view<bf16>(ptr[0], st), in_view<bf16>(ptr[1], st + 3), in_view<bf16>(ptr[2], st + 6),
      out_view<bf16>(ptr[3], st + 9), lse, s.heads, s.nq, s.nk, s.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_wgmma(void* const* ptr, const long long* st, float* lse, Shape s,
                      cudaStream_t stream) {
  constexpr uint32_t smem = hw::FwdLayout<D>::bytes;
  static const cudaError_t attr = allow_smem(hw::flash_fwd<D>, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap qm, km, vm;
  if (!heads_map<D>(&qm, ptr, st, 0, s, s.nq, hw::kRows) ||
      !heads_map<D>(&km, ptr, st, 1, s, s.nk, hw::kFwdKeys) ||
      !heads_map<D>(&vm, ptr, st, 2, s, s.nk, hw::kFwdKeys))
    return cudaErrorInvalidValue;
  hw::flash_fwd<D><<<s.grid(s.nq, hw::kRows), hw::kThreads, smem, stream>>>(
      qm, km, vm, out_view<bf16>(ptr[3], st + 9), lse, s.heads, s.nq, s.nk, s.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(void* const* ptr, const long long* st, const float* lse, const float* delta,
                   Shape s, cudaStream_t stream) {
  const size_t smem = simt::dq_smem(D);
  cudaError_t err = allow_smem(simt::flash_dq<D>, smem);
  if (err != cudaSuccess) return err;
  simt::flash_dq<D><<<s.grid(s.nq), simt::kThreads, smem, stream>>>(
      in_view<float>(ptr[0], st), in_view<float>(ptr[1], st + 3), in_view<float>(ptr[2], st + 6),
      in_view<float>(ptr[3], st + 9), lse, delta, out_view<float>(ptr[4], st + 12), s.heads,
      s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_mma_sync(void* const* ptr, const long long* st, const float* lse,
                        const float* delta, Shape s, cudaStream_t stream) {
  const size_t smem = tc::dq_smem(D);
  cudaError_t err = allow_smem(tc::flash_dq<D>, smem);
  if (err != cudaSuccess) return err;
  tc::flash_dq<D><<<s.grid(s.nq), tc::kThreads, smem, stream>>>(
      in_view<bf16>(ptr[0], st), in_view<bf16>(ptr[1], st + 3), in_view<bf16>(ptr[2], st + 6),
      in_view<bf16>(ptr[3], st + 9), lse, delta, out_view<bf16>(ptr[4], st + 12), s.heads, s.nq,
      s.nk, s.scale);
  return cudaGetLastError();
}

// q, k, v, do: the four inputs' tensor maps in the order of ptr, boxes of
// `own` rows for the tensors a block keeps (q and do for dq, k and v for
// dk/dv) and of hw::kBwdRows for the ones it streams
template <int D>
bool bwd_maps(CUtensorMap (&m)[4], void* const* ptr, const long long* st, const Shape& s,
              bool dq) {
  const int qrows = dq ? hw::kRows : hw::kBwdRows, krows = dq ? hw::kBwdRows : hw::kRows;
  return heads_map<D>(&m[0], ptr, st, 0, s, s.nq, qrows) &&
         heads_map<D>(&m[1], ptr, st, 1, s, s.nk, krows) &&
         heads_map<D>(&m[2], ptr, st, 2, s, s.nk, krows) &&
         heads_map<D>(&m[3], ptr, st, 3, s, s.nq, qrows);
}

template <int D>
cudaError_t dq_wgmma(void* const* ptr, const long long* st, const float* lse, const float* delta,
                     Shape s, cudaStream_t stream) {
  constexpr uint32_t smem = hw::DqLayout<D>::bytes;
  static const cudaError_t attr = allow_smem(hw::flash_dq<D>, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[4];
  if (!bwd_maps<D>(m, ptr, st, s, true)) return cudaErrorInvalidValue;
  hw::flash_dq<D><<<s.grid(s.nq, hw::kRows), hw::kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, out_view<bf16>(ptr[4], st + 12), s.heads, s.nq, s.nk,
      s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_f32(void* const* ptr, const long long* st, const float* lse, const float* delta,
                    Shape s, cudaStream_t stream) {
  const size_t smem = simt::dkv_smem(D);
  cudaError_t err = allow_smem(simt::flash_dkv<D>, smem);
  if (err != cudaSuccess) return err;
  simt::flash_dkv<D><<<s.grid(s.nk), simt::kThreads, smem, stream>>>(
      in_view<float>(ptr[0], st), in_view<float>(ptr[1], st + 3), in_view<float>(ptr[2], st + 6),
      in_view<float>(ptr[3], st + 9), lse, delta, out_view<float>(ptr[4], st + 12),
      out_view<float>(ptr[5], st + 15), s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_mma_sync(void* const* ptr, const long long* st, const float* lse,
                         const float* delta, Shape s, cudaStream_t stream) {
  const size_t smem = tc::dkv_smem(D);
  cudaError_t err = allow_smem(tc::flash_dkv<D>, smem);
  if (err != cudaSuccess) return err;
  tc::flash_dkv<D><<<s.grid(s.nk), tc::kThreads, smem, stream>>>(
      in_view<bf16>(ptr[0], st), in_view<bf16>(ptr[1], st + 3), in_view<bf16>(ptr[2], st + 6),
      in_view<bf16>(ptr[3], st + 9), lse, delta, out_view<bf16>(ptr[4], st + 12),
      out_view<bf16>(ptr[5], st + 15), s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_wgmma(void* const* ptr, const long long* st, const float* lse,
                      const float* delta, Shape s, cudaStream_t stream) {
  constexpr uint32_t smem = hw::DkvLayout<D>::bytes;
  static const cudaError_t attr = allow_smem(hw::flash_dkv<D>, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[4];
  if (!bwd_maps<D>(m, ptr, st, s, false)) return cudaErrorInvalidValue;
  hw::flash_dkv<D><<<s.grid(s.nk, hw::kRows), hw::kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, out_view<bf16>(ptr[4], st + 12),
      out_view<bf16>(ptr[5], st + 15), s.heads, s.nq, s.nk, s.scale);
  return cudaGetLastError();
}

// the dynamic shared memory of one block of each kernel (0: forward, 1: dq,
// 2: dk/dv) at head size d, in bytes; 0 where the kernel has no such size
size_t smem_of(int kernel, int which, int d) {
  const int i = which * 3 + (d == 32 ? 0 : d == 64 ? 1 : d == 128 ? 2 : 3);
  switch (kernel * 16 + i) {
    case kSimt * 16 + 0: return simt::fwd_smem(32);
    case kSimt * 16 + 1: return simt::fwd_smem(64);
    case kSimt * 16 + 2: return simt::fwd_smem(128);
    case kSimt * 16 + 3: return simt::dq_smem(32);
    case kSimt * 16 + 4: return simt::dq_smem(64);
    case kSimt * 16 + 5: return simt::dq_smem(128);
    case kSimt * 16 + 6: return simt::dkv_smem(32);
    case kSimt * 16 + 7: return simt::dkv_smem(64);
    case kSimt * 16 + 8: return simt::dkv_smem(128);
    case kMmaSync * 16 + 0: return tc::fwd_smem(32);
    case kMmaSync * 16 + 3: return tc::dq_smem(32);
    case kMmaSync * 16 + 6: return tc::dkv_smem(32);
    case kWgmma * 16 + 1: return hw::FwdLayout<64>::bytes;
    case kWgmma * 16 + 2: return hw::FwdLayout<128>::bytes;
    case kWgmma * 16 + 4: return hw::DqLayout<64>::bytes;
    case kWgmma * 16 + 5: return hw::DqLayout<128>::bytes;
    case kWgmma * 16 + 7: return hw::DkvLayout<64>::bytes;
    case kWgmma * 16 + 8: return hw::DkvLayout<128>::bytes;
    default: return 0;
  }
}

}  // namespace

// ptr: q (B, H, Nq, D), k and v (B, H, Nk, D), out (B, H, Nq, D); st: the
// (batch, head, row) strides of each, in elements, last stride 1. lse:
// (B, H, Nq) f32, contiguous. All four tensors f32 (is_bf16 = 0) or all
// bf16; d in {32, 64, 128}. bf16 tensors start 16-byte aligned with strides
// that are multiples of 8. kernel (Kernel) from the wrapper's plan;
// cudaErrorInvalidValue, and nothing launched, when it does not take the
// call (or a tensor map cannot be made).
extern "C" int ks_flash_attention_fwd(void* const* ptr, const long long* st, void* lse, int batch,
                                      int heads, int nq, int nk, int d, float scale, int is_bf16,
                                      int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, d)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<float*>(lse);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel * 256 + d) {
    case kSimt * 256 + 32: err = fwd_f32<32>(ptr, st, l, shape, s); break;
    case kSimt * 256 + 64: err = fwd_f32<64>(ptr, st, l, shape, s); break;
    case kSimt * 256 + 128: err = fwd_f32<128>(ptr, st, l, shape, s); break;
    case kMmaSync * 256 + 32: err = fwd_mma_sync<32>(ptr, st, l, shape, s); break;
    case kWgmma * 256 + 64: err = fwd_wgmma<64>(ptr, st, l, shape, s); break;
    case kWgmma * 256 + 128: err = fwd_wgmma<128>(ptr, st, l, shape, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// ptr: q, k, v, do (inputs), dq (output), each with its three strides in st;
// lse and delta (B, H, Nq) f32, contiguous; kernel as for the forward.
extern "C" int ks_flash_attention_dq(void* const* ptr, const long long* st, const void* lse,
                                     const void* delta, int batch, int heads, int nq, int nk,
                                     int d, float scale, int is_bf16, int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, d)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel * 256 + d) {
    case kSimt * 256 + 32: err = dq_f32<32>(ptr, st, l, dl, shape, s); break;
    case kSimt * 256 + 64: err = dq_f32<64>(ptr, st, l, dl, shape, s); break;
    case kSimt * 256 + 128: err = dq_f32<128>(ptr, st, l, dl, shape, s); break;
    case kMmaSync * 256 + 32: err = dq_mma_sync<32>(ptr, st, l, dl, shape, s); break;
    case kWgmma * 256 + 64: err = dq_wgmma<64>(ptr, st, l, dl, shape, s); break;
    case kWgmma * 256 + 128: err = dq_wgmma<128>(ptr, st, l, dl, shape, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// ptr: q, k, v, do (inputs), dk, dv (outputs), each with its three strides
// in st; lse and delta (B, H, Nq) f32, contiguous; kernel as for the forward.
extern "C" int ks_flash_attention_dkv(void* const* ptr, const long long* st, const void* lse,
                                      const void* delta, int batch, int heads, int nq, int nk,
                                      int d, float scale, int is_bf16, int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, d)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto dl = static_cast<const float*>(delta);
  const Shape shape{batch, heads, nq, nk, scale};
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel * 256 + d) {
    case kSimt * 256 + 32: err = dkv_f32<32>(ptr, st, l, dl, shape, s); break;
    case kSimt * 256 + 64: err = dkv_f32<64>(ptr, st, l, dl, shape, s); break;
    case kSimt * 256 + 128: err = dkv_f32<128>(ptr, st, l, dl, shape, s); break;
    case kMmaSync * 256 + 32: err = dkv_mma_sync<32>(ptr, st, l, dl, shape, s); break;
    case kWgmma * 256 + 64: err = dkv_wgmma<64>(ptr, st, l, dl, shape, s); break;
    case kWgmma * 256 + 128: err = dkv_wgmma<128>(ptr, st, l, dl, shape, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory a block of `kernel` takes for the forward
// (which 0), dq (1) or dk/dv (2) at head size d, in bytes (0: no such
// kernel), so the wrapper's plan can be held to the kernels' own numbers.
extern "C" long long ks_flash_attention_smem(int kernel, int which, int d) {
  return static_cast<long long>(smem_of(kernel, which, d));
}
