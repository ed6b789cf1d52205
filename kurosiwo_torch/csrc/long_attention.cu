// Non-causal multi-head attention for long queries over short keys on the
// packed (B, N, H*D) layout, bf16, D 64, 1-64 keys: forward (out, lse) and
// backward (dq, dk, dv). Its callers are BiT-CD's transformer decoder (the
// 56x56 map's 3,136 pixels over 4 tokens) and ChangeFormer's stage 2 (784
// queries over 49 reduced keys); the wrapper's plan
// (ops/short_attention.py: short_plan, kernel "wgmma_long") names these
// kernels for bf16 calls at D 64 with Nq > 256 over at most 64 keys.
//
// Replaces the TPU kernels kurosiwo_tpu/ops/pallas_attention.py::
// _short_fwd_kernel (:259, launched by _short_fwd_local, :332) and
// _short_bwd_kernel (:283, launched by _short_bwd_local, :392) for those
// calls, as short_attention.cu does for the others.
// There delta = sum_d(do * out) comes from the caller (_short_vjp_bwd,
// :385); here the backward computes it from the tile of out.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes. At b128
// the decoder's forward must read Q and write out and lse (835.7 MB,
// 0.2495 ms), its backward read Q, dO, out and lse and write dQ (1.66 GB,
// 0.4953 ms); K, V, dK and dV are 0.5 MB. The products are under 5% of the
// bf16 rate at 16 keys. short_attention.cu's mma.sync kernels, which took
// these calls before, hold 64-row K/V tiles of which 4 rows are real there,
// one block a query tile with nothing overlapping its loads, after a
// plain-torch delta pass of 5.8 GB in the backward.
//
// Here a unit is (batch, head, chunk of query tiles; ops/short_attention.py:
// long_chunk) and a block one warpgroup, several resident an SM walking the
// units: the unit's K and V land once by TMA through the rank-4 maps (so
// the strided column halves of one kv tensor need no copy), and its query
// tiles stream on a TMA ring issued ahead by thread 0. The keys sit on the
// N or K side of every product, sized to the keys rounded up to 16 (NK),
// not to wgmma's 64 rows.
//  * forward (hw::long_fwd): every key is resident, so the softmax is exact
//    in one pass, as on the TPU: S = Q K^T is m64nNK over D, keys past Nk are
//    -inf, P / l rounded to bf16 (as the TPU kernel rounds) is the RS A
//    operand of O = (P / l) V with K = NK; lse in natural log; O leaves
//    through a shared tile and a TMA store.
//  * backward (hw::long_bwd, then hw::long_bwd_sum): one fused pass over Q,
//    dO and out, delta = sum_d dO out of each row from the tile of out;
//    S = Q K^T and dP = dO V^T (m64nNK), P and dS in f32 rounded to bf16 (as
//    the TPU kernel rounds) and stored transposed to shared memory, dV^T +=
//    dO^T P and dK^T += Q^T dS (M = D, N = NK, K = the tile's 64 queries, Q
//    and dO as MN-major A) in registers over the unit, dQ = dS K (RS, K =
//    NK) written once a tile. The units' f32 dK and dV partials are summed
//    in unit order by a second small launch: no float atomics, two runs
//    bitwise equal.
#include "attention_hw.cuh"

namespace {

namespace hw {

// Shared memory of the long-query kernels (one warpgroup a block, NK: the
// keys rounded up to 16): the unit's K and V tiles (64-row boxes; rows past
// Nk read as 0), a ring of query-tile stages (Q in the forward; Q, dO and
// out in the backward), in the forward the out tile that a TMA store
// writes, in the backward P^T and dS^T of one query tile ([NK keys][64
// queries] bf16, B128), the mbarriers (K/V, then one a ring stage) and 1 KB
// of alignment slack.
template <int NK>
struct LongLayout {
  static constexpr uint32_t T = tile_bytes(64), kKeysT = NK * 128;
  static constexpr int kFwdStages = 3, kBwdStages = 2;
  static constexpr int kFwdBlocks = 4, kBwdBlocks = NK <= 32 ? 3 : 2;  // resident an SM
  static constexpr uint32_t fwd_bytes = (3 + kFwdStages) * T + 8 * (1 + kFwdStages) + 1024;
  static constexpr uint32_t bwd_bytes =
      (2 + 3 * kBwdStages) * T + 2 * kKeysT + 8 * (1 + kBwdStages) + 1024;
};

// Unit u of a long-query launch: item u / chunks (one (batch, head)) and its
// query tiles [t0, t1), chunk c = u % chunks of `chunk` tiles each
struct LongUnit {
  int item, t0, t1;
  __device__ LongUnit(int u, int chunks, int chunk, int nqt)
      : item(u / chunks), t0((u % chunks) * chunk), t1(min(t0 + chunk, nqt)) {}
};

// 16-bit store to shared memory, and the B128 offset of element (row, col)
// of a tile of 64-column rows
__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(static_cast<unsigned short>(v))
               : "memory");
}
__device__ __forceinline__ uint32_t b128_at(int row, int col) {
  return row * 128 + (((col / 8) ^ (row & 7)) << 4) + 2 * (col % 8);
}

// Forward at D 64 over at most 64 keys: a unit is (batch, head, chunk of
// query tiles). Thread 0 copies the unit's K and V once and keeps the
// unit's Q tiles on a ring of kFwdStages TMA stages; the warpgroup takes
// them in order. Every key is resident, so the softmax is exact in one
// pass, as on the TPU: S = Q K^T is one m64nNK product over D, keys past Nk
// are -inf, P / l is rounded to bf16 as the RS A operand of O = (P / l) V
// (K = NK). O goes out through a shared tile and a TMA store (whole
// 128-byte rows; rows past Nq are not written). Resident blocks walk the
// units.
template <int NK>
__global__ void __launch_bounds__(128, LongLayout<NK>::kFwdBlocks)
long_fwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
         float* __restrict__ lse, int heads, int units, int chunks, int chunk, int nq, int nk,
         float scale_log2) {
  using L = LongLayout<NK>;
  constexpr int S = L::kFwdStages;
  constexpr uint32_t T = L::T;
  extern __shared__ __align__(1024) unsigned char hw_smem[];
  const uint32_t base = (hopper::smem_addr(hw_smem) + 1023) & ~1023u;
  const uint32_t ktile = base, vtile = base + T, ring = base + 2 * T, otile = ring + S * T;
  const uint32_t kv_full = otile + T, full = kv_full + 8;
  const int nqt = (nq + kRows - 1) / kRows, lane = threadIdx.x & 31, w4 = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int n = 0, g = 0;  // units and query tiles this block has taken
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const LongUnit w(u, chunks, chunk, nqt);
    const int b = w.item / heads, h = w.item % heads;
    auto issue = [&](int t, int gt) {  // thread 0: query tile t into the stage of tile count gt
      const uint32_t bar = full + 8 * (gt % S);
      mbar_arrive_expect_tx(bar, T);
      load_tile<64>(ring + (gt % S) * T, qmap, t * kRows, h, b, bar);
    };
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * T);
      load_tile<64>(ktile, kmap, 0, h, b, kv_full);
      load_tile<64>(vtile, vmap, 0, h, b, kv_full);
      for (int i = 0; i < S && w.t0 + i < w.t1; ++i) issue(w.t0 + i, g + i);
    }
    mbar_wait(kv_full, n & 1);
    for (int t = w.t0; t < w.t1; ++t, ++g) {
      const uint32_t qtile = ring + (g % S) * T;
      mbar_wait(full + 8 * (g % S), (g / S) & 1);
      float s[NK / 2];
      zero(s);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NK, 0, 0>(s, kmajor(qtile, kk), kmajor(ktile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        if (8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= nk) s[i] = -INFINITY;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
      }
      float neg_m[2], l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) neg_m[r] = -quad_max(mx[r]) * scale_log2;  // finite: nk >= 1
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        s[i] = ex2(fmaf(s[i], scale_log2, neg_m[(i / 2) & 1]));
        l[(i / 2) & 1] += s[i];
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
      }
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) s[i] *= inv[(i / 2) & 1];
      uint32_t p[NK / 16][4];
      hopper::accumulator_as_a<NK>(p, s);  // p / l rounded to bf16, as the TPU kernel
      float acc[32];
      zero(acc);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs<64>(acc, p[kk], mnmajor(vtile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      if (threadIdx.x == 0) hopper::bulk_wait_read<0>();  // the last tile's store has read otile
      __syncthreads();  // otile is free; every warp is done with this stage (after a unit, K, V)
      if (threadIdx.x == 0 && t + S < w.t1) issue(t + S, g + S);
      // O rounded to bf16 into otile (B128): this thread's rows r and r + 8,
      // 16-byte chunk j of each, 4 bytes at 4 (lane % 4)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * w4 + lane / 4 + 8 * hh;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sts32(otile + r * 128 + ((j ^ (r & 7)) << 4) + 4 * (lane % 4),
                ks::pack(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]));
      }
      hopper::fence_proxy_async();  // the stores, visible to the TMA store
      __syncthreads();
      if (threadIdx.x == 0) {
        hopper::tma_store_4d(omap, otile, 0, t * kRows, h, b);
        hopper::bulk_commit();
      }
      if (lane % 4 == 0) {
        const int r = t * kRows + 16 * w4 + lane / 4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (r + 8 * hh < nq)
            lse[static_cast<long long>(w.item) * nq + r + 8 * hh] = -neg_m[hh] * kLn2 + logf(l[hh]);
      }
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<0>();  // the last store is done with shared memory
}

// Backward at D 64 over at most 64 keys, one fused kernel a unit (batch,
// head, chunk of query tiles), no float atomics. Thread 0 copies K and V
// once a unit and keeps (Q, dO, out) tiles on a ring of kBwdStages TMA
// stages. The keys sit on the N or K side of every product, so each is
// sized to the NK real keys, not to wgmma's 64 rows: per 64-query tile
// S = Q K^T and dP = dO V^T (m64nNK, SS); delta = sum_d dO out of each row
// from the tile of out; P = exp(scale S - lse) and dS = P (dP - delta)
// scale in f32, rounded to bf16, stored transposed ([keys][queries]);
// dV^T += dO^T P and dK^T += Q^T dS (M = D 64, N = NK, K = the tile's 64
// queries; the Q and dO tiles as MN-major A) in f32 registers over the
// unit's tiles; dQ = dS K (RS, K = NK) written once a tile. Each unit
// writes its dK and dV as f32 partials ([unit][dK, dV][nk][64]), summed in
// unit order by long_bwd_sum.
template <int NK>
__global__ void __launch_bounds__(128, LongLayout<NK>::kBwdBlocks)
long_bwd(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
         const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse, View<bf16> dq,
         float* __restrict__ part, int heads, int units, int chunks, int chunk, int nq, int nk,
         float scale) {
  using L = LongLayout<NK>;
  constexpr int S = L::kBwdStages;
  constexpr uint32_t T = L::T;
  extern __shared__ __align__(1024) unsigned char hw_smem[];
  const uint32_t raw = hopper::smem_addr(hw_smem), base = (raw + 1023) & ~1023u;
  const unsigned char* const sbase = hw_smem + (base - raw);
  const uint32_t ktile = base, vtile = base + T, ring = base + 2 * T;
  const uint32_t pT = ring + S * 3 * T, dsT = pT + L::kKeysT;
  const uint32_t kv_full = dsT + L::kKeysT, full = kv_full + 8;
  const int nqt = (nq + kRows - 1) / kRows, lane = threadIdx.x & 31, w4 = threadIdx.x / 32;
  // this thread's rows of an accumulator: row and row + 8 (query rows of a
  // tile in S, dP and dQ; D rows in dK^T and dV^T)
  const int row = 16 * w4 + lane / 4;
  const float scale_log2 = scale * kLog2e;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int n = 0, g = 0;  // units and query tiles this block has taken
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const LongUnit w(u, chunks, chunk, nqt);
    const int b = w.item / heads, h = w.item % heads;
    auto issue = [&](int t, int gt) {  // thread 0: tile t of Q, dO and out into gt's stage
      const uint32_t bar = full + 8 * (gt % S), st = ring + (gt % S) * 3 * T;
      mbar_arrive_expect_tx(bar, 3 * T);
      load_tile<64>(st, qmap, t * kRows, h, b, bar);
      load_tile<64>(st + T, domap, t * kRows, h, b, bar);
      load_tile<64>(st + 2 * T, omap, t * kRows, h, b, bar);
    };
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * T);
      load_tile<64>(ktile, kmap, 0, h, b, kv_full);
      load_tile<64>(vtile, vmap, 0, h, b, kv_full);
      for (int i = 0; i < S && w.t0 + i < w.t1; ++i) issue(w.t0 + i, g + i);
    }
    float dkT[NK / 2], dvT[NK / 2];  // rows: D, columns: keys
    zero(dkT);
    zero(dvT);
    mbar_wait(kv_full, n & 1);
    for (int t = w.t0; t < w.t1; ++t, ++g) {
      const uint32_t qtile = ring + (g % S) * 3 * T, dotile = qtile + T, otile = qtile + 2 * T;
      float lse2[2];  // lse * log2(e); +inf past nq, so p = 0 there
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = t * kRows + row + 8 * hh;
        lse2[hh] = r < nq ? lse[static_cast<long long>(w.item) * nq + r] * kLog2e : INFINITY;
      }
      mbar_wait(full + 8 * (g % S), (g / S) & 1);
      // delta = sum_d dO out of the two rows in f32: each lane of the row's
      // quad takes 16 columns (two 16-byte chunks), then the quad's sum
      float delta[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row + 8 * hh;
        float acc = 0.f;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const uint32_t off = r * 128 + (((2 * (lane % 4) + cc) ^ (r & 7)) << 4);
          acc = dot8(*reinterpret_cast<const uint4*>(sbase + (dotile - base) + off),
                     *reinterpret_cast<const uint4*>(sbase + (otile - base) + off), acc);
        }
        delta[hh] = quad_sum(acc);
      }
      float sa[NK / 2], dp[NK / 2];
      zero(sa);
      zero(dp);
      fence_regs(sa);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NK, 0, 0>(sa, kmajor(qtile, kk), kmajor(ktile, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NK, 0, 0>(dp, kmajor(dotile, kk), kmajor(vtile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dp);
      // P = exp(scale S - lse), dS = P (dP - delta) scale; keys past nk: p = 0
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        const int hh = (i / 2) & 1;
        float p = ex2(fmaf(sa[i], scale_log2, -lse2[hh]));
        p = 8 * (i / 4) + 2 * (lane % 4) + (i & 1) < nk ? p : 0.f;
        sa[i] = p;
        dp[i] = p * (dp[i] - delta[hh]) * scale;
      }
      uint32_t pa[NK / 16][4], da[NK / 16][4];
      hopper::accumulator_as_a<NK>(pa, sa);  // p rounded to bf16 for dV
      hopper::accumulator_as_a<NK>(da, dp);  // ds rounded to bf16 for dK and dQ
      // P^T and dS^T into shared memory: pa[kk][i] holds query row + 8 (i & 1)
      // of the tile at keys 16 kk + 8 (i / 2) + 2 (lane % 4) and + 1
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = row + 8 * (i & 1), key = 16 * kk + 8 * (i / 2) + 2 * (lane % 4);
          sts16(pT + b128_at(key, q), pa[kk][i]);
          sts16(pT + b128_at(key + 1, q), pa[kk][i] >> 16);
          sts16(dsT + b128_at(key, q), da[kk][i]);
          sts16(dsT + b128_at(key + 1, q), da[kk][i] >> 16);
        }
      hopper::fence_proxy_async();  // the stores, visible to wgmma
      __syncthreads();              // every warp's P^T and dS^T rows are in place
      float dqa[32];
      zero(dqa);
      fence_regs(dqa);
      fence_regs(dkT);
      fence_regs(dvT);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NK, 1, 0>(dvT, mnmajor(dotile, kk), kmajor(pT, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NK, 1, 0>(dkT, mnmajor(qtile, kk), kmajor(dsT, kk), 1);
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs<64>(dqa, da[kk], mnmajor(ktile, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(dkT);
      fence_regs(dvT);
      fence_regs(da);
      store_acc<64>(dq.p + b * dq.sb + static_cast<long long>(h) * 64, dq.sn, t * kRows, nq, dqa);
      __syncthreads();  // every warp is done with this stage, P^T and dS^T (and K, V)
      if (threadIdx.x == 0 && t + S < w.t1) issue(t + S, g + S);
    }
    // the unit's dK and dV (this thread: D rows row, row + 8; key columns)
    float* const pu = part + static_cast<long long>(u) * 2 * nk * 64;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      const int key = 8 * (i / 4) + 2 * (lane % 4) + (i & 1), d = row + 8 * ((i / 2) & 1);
      if (key < nk) {
        pu[key * 64 + d] = dkT[i];
        pu[(nk + key) * 64 + d] = dvT[i];
      }
    }
  }
}

// dK and dV of each item: the sum of its units' f32 partials in unit order,
// rounded to bf16; one thread an element (dK or dV, key, d) of item
// blockIdx.y (32-bit index arithmetic: 64-bit division is slow here)
__global__ void long_bwd_sum(const float* __restrict__ part, View<bf16> dk, View<bf16> dv,
                             int heads, int chunks, int nk) {
  const int per_item = 2 * nk * 64, rest = blockIdx.x * blockDim.x + threadIdx.x;
  if (rest >= per_item) return;
  const int item = blockIdx.y, which = rest / (nk * 64), key = (rest / 64) % nk, d = rest % 64;
  const float* src = part + static_cast<long long>(item) * chunks * per_item + rest;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += src[static_cast<long long>(c) * per_item];
  const View<bf16> dst = which ? dv : dk;
  dst.p[(item / heads) * dst.sb + key * dst.sn + (item % heads) * 64 + d] = __float2bfloat16(acc);
}

}  // namespace hw

// ===================================================================== host

// whether the kernels compute a call of this dtype, head size and length
bool long_takes(bool bf16, int d, int nq, int nk) {
  return bf16 && d == 64 && nq >= 1 && nk >= 1 && nk <= 64;
}

// their instantiation: the keys rounded up to 16
int long_keys(int nk) { return (nk + 15) / 16 * 16; }

// units of a launch: every (batch, head) cut into chunks of `chunk` query tiles
int long_units(const Shape& s, int chunk, int* chunks) {
  *chunks = (tiles_of(s.nq) + chunk - 1) / chunk;
  return s.batch * s.heads * *chunks;
}

template <int NK>
cudaError_t fwd_long(void* const* ptr, const long long* st, float* lse, Shape s, int chunk,
                     cudaStream_t stream) {
  using L = hw::LongLayout<NK>;
  const auto kernel = hw::long_fwd<NK>;
  static const cudaError_t attr = allow_smem(kernel, L::fwd_bytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap qm, km, vm, om;
  if (!heads_map(&qm, ptr, st, 0, s, s.nq, 64) || !heads_map(&km, ptr, st, 1, s, s.nk, 64) ||
      !heads_map(&vm, ptr, st, 2, s, s.nk, 64) || !heads_map(&om, ptr, st, 3, s, s.nq, 64))
    return cudaErrorInvalidValue;
  int chunks = 0;
  const int units = long_units(s, chunk, &chunks);
  const int grid = resident_grid(kernel, 128, L::fwd_bytes, units);
  kernel<<<grid, 128, L::fwd_bytes, stream>>>(qm, km, vm, om, lse, s.heads, units, chunks, chunk,
                                               s.nq, s.nk, s.scale * hw::kLog2e);
  return cudaGetLastError();
}

template <int NK>
cudaError_t bwd_long(void* const* ptr, const long long* st, const float* lse, float* part,
                     Shape s, int chunk, cudaStream_t stream) {
  using L = hw::LongLayout<NK>;
  const auto kernel = hw::long_bwd<NK>;
  static const cudaError_t attr = allow_smem(kernel, L::bwd_bytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[5];
  const int rows[5] = {s.nq, s.nk, s.nk, s.nq, s.nq};  // q, k, v, do, out
  for (int i = 0; i < 5; ++i)
    if (!heads_map(&m[i], ptr, st, i, s, rows[i], 64)) return cudaErrorInvalidValue;
  int chunks = 0;
  const int units = long_units(s, chunk, &chunks), items = s.batch * s.heads;
  const int grid = resident_grid(kernel, 128, L::bwd_bytes, units);
  kernel<<<grid, 128, L::bwd_bytes, stream>>>(m[0], m[1], m[2], m[3], m[4], lse,
                                               out_view<bf16>(ptr[5], st + 10), part, s.heads,
                                               units, chunks, chunk, s.nq, s.nk, s.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hw::long_bwd_sum<<<dim3((2 * s.nk * 64 + 255) / 256, items), 256, 0, stream>>>(
      part, out_view<bf16>(ptr[6], st + 12), out_view<bf16>(ptr[7], st + 14), s.heads, chunks,
      s.nk);
  return cudaGetLastError();
}

}  // namespace

// The forward (bf16, D 64, 1 <= Nk <= 64; the wrapper's plan names it for
// Nq > 256): ptr, st, lse and is_bf16 as short_attention.cu's
// ks_short_attention_fwd; chunk (>= 1): query tiles of one unit
// (ops/short_attention.py: long_chunk). cudaErrorInvalidValue, and nothing
// launched, for a call the kernels do not take.
extern "C" int ks_long_attention_fwd(void* const* ptr, const long long* st, void* lse, int batch,
                                     int heads, int nq, int nk, int d, float scale, int is_bf16,
                                     int chunk, void* stream) {
  if (!long_takes(is_bf16 != 0, d, nq, nk) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<float*>(lse);
  const Shape shape{batch, heads, nq, nk, scale};
  switch (long_keys(nk)) {
    case 16: return static_cast<int>(fwd_long<16>(ptr, st, l, shape, chunk, s));
    case 32: return static_cast<int>(fwd_long<32>(ptr, st, l, shape, chunk, s));
    case 48: return static_cast<int>(fwd_long<48>(ptr, st, l, shape, chunk, s));
    case 64: return static_cast<int>(fwd_long<64>(ptr, st, l, shape, chunk, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ptr and st as short_attention.cu's ks_short_attention_bwd (delta is
// computed inside); part: f32 scratch of units x 2 x nk x 64 (units = B H
// ceil(ceil(Nq / 64) / chunk)), the units' dK and dV before their
// fixed-order sum.
extern "C" int ks_long_attention_bwd(void* const* ptr, const long long* st, const void* lse,
                                     void* part, int batch, int heads, int nq, int nk, int d,
                                     float scale, int is_bf16, int chunk, void* stream) {
  if (!long_takes(is_bf16 != 0, d, nq, nk) || chunk < 1 || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto p = static_cast<float*>(part);
  const Shape shape{batch, heads, nq, nk, scale};
  switch (long_keys(nk)) {
    case 16: return static_cast<int>(bwd_long<16>(ptr, st, l, p, shape, chunk, s));
    case 32: return static_cast<int>(bwd_long<32>(ptr, st, l, p, shape, chunk, s));
    case 48: return static_cast<int>(bwd_long<48>(ptr, st, l, p, shape, chunk, s));
    case 64: return static_cast<int>(bwd_long<64>(ptr, st, l, p, shape, chunk, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory (bytes) and blocks an SM of the long-query forward (which 0)
// or backward (1) at nk keys; 0 where they do not take nk.
extern "C" long long ks_long_attention_footprint(int which, int nk, int* blocks) {
  *blocks = 0;
  if (!long_takes(true, 64, 1, nk)) return 0;
#define KS_LONG(NK)                                                                            \
  case NK:                                                                                     \
    if (which == 0) {                                                                          \
      allow_smem(hw::long_fwd<NK>, hw::LongLayout<NK>::fwd_bytes);                             \
      *blocks = blocks_per_sm(hw::long_fwd<NK>, 128, hw::LongLayout<NK>::fwd_bytes);           \
      return hw::LongLayout<NK>::fwd_bytes;                                                    \
    }                                                                                          \
    allow_smem(hw::long_bwd<NK>, hw::LongLayout<NK>::bwd_bytes);                               \
    *blocks = blocks_per_sm(hw::long_bwd<NK>, 128, hw::LongLayout<NK>::bwd_bytes);             \
    return hw::LongLayout<NK>::bwd_bytes;
  switch (long_keys(nk)) {
    KS_LONG(16)
    KS_LONG(32)
    KS_LONG(48)
    KS_LONG(64)
    default: return 0;
  }
#undef KS_LONG
}
