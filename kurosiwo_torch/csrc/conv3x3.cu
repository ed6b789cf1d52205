// 3x3 SAME stride-1 convolution on NHWC as an implicit GEMM, with two
// epilogues:
//  * B6 (ks_conv3x3_bn_stats): y in x's dtype plus per-channel f32 [sum y,
//    sum y^2] for the BatchNorm batch statistics, with an optional
//    relu(scale * x + bias) prologue on the input. Replaces the TPU kernel
//    kurosiwo_tpu/ops/pallas_conv_bn.py::conv3x3_bn_stats (:35; its inner
//    `kernel`, launched at :115).
//  * B8 (ks_conv3x3_bias_act): y = [relu](conv + bias) in x's dtype for any
//    channel count: f32, and the bf16 calls that conv_fused.cu's slab kernel
//    does not take. Replaces kurosiwo_tpu/ops/pallas_conv.py::_conv_kernel
//    (conv3x3_fused, launched at :85).
//
// GEMM: M = output pixels (B*H*W), N = Cout, K = 9*Cin, walked in chunks of
// input channels and taps. A block owns a BM x BN output tile; for each tap
// it reads the BM pixels shifted by (dh, dw) straight from x: it computes
// its own halo offsets (pixel m + dh*W + dw) and masks the image edge to 0,
// so the TPU kernel's row-slab DMA and 8-aligned width padding have no
// counterpart. The weight is the (9*Cin, Cout) row-major view of HWIO.
//
// Bound on an H100: B6 at the UNet shapes (Cin, Cout >= 256 at 14^2 and 7^2,
// batch 128) does 29.6-89 GFLOP over 13-40 MB: operations (989 TFLOP/s
// bf16). B8 at C 16/32 (K = 144/288) does about 2*K operations per 2*Cout
// bytes: bytes (3.35 TB/s).
//
// Three kernels; the wrapper (ops/conv_bn.py: conv3x3_plan) picks one by
// dtype, epilogue and shape, and the entry points refuse a call the named
// kernel does not take:
//  * wgmma_conv3x3 (B6 in bf16 without the prologue, Cin % 64 == 0, Cout %
//    128 == 0: every routed call): Hopper's warpgroup products. Each of
//    three warpgroups owns 64 pixel rows x 128 channels of a 192-pixel tile
//    (1.98 waves of the 132 SMs at 14^2, one at 7^2) and issues
//    wgmma m64n128k16 on operands in 128-byte-swizzled shared memory: the
//    pixel tile K-major (64 channels a row), the weight rows MN-major, as
//    they lie in memory. Both arrive by TMA (hopper.cuh: ring_gemm) through
//    a ring of 5 stages, three chunks of 64 channels ahead, completion
//    counted on one mbarrier a stage: one thread asks for three boxes a
//    chunk, and no thread computes an address or stages a value in
//    registers. The pixel box is the tile's rows shifted by the tap in the
//    flat (B*H*W, Cin) view; rows outside the tensor read as 0, and the
//    rows whose shifted pixel left the image (the halo) are zeroed in
//    shared memory before the product. One barrier per 64-deep chunk, at
//    most one wgmma group in flight.
//  * tc_conv3x3 (the prologue variant, and B8 in bf16 off the slab kernel):
//    mma.sync m16n8k16 with f32 accumulators, fragments by ldmatrix from
//    padded tiles, two shared buffers with the next chunk's loads staged in
//    registers.
//  * simt_conv3x3 (f32): CUDA-core FMA (64x64 tiles, 4x4 per thread), so
//    f32 results match the CPU's f32 with TF32 off.
// The prologue runs in f32 on the loaded A vector of a pixel inside the
// image and rounds to x's dtype before the product, as the TPU kernel does;
// a halo pixel stays 0 (the network pads after the activation).
// B6's statistics come from the f32 accumulators before y is rounded (as
// pallas_conv_bn.py:105-108): each block writes its tile's per-channel
// partials (a shuffle over a warp's rows, then a fixed-order sum over its
// warps), and a second launch sums the pixel tiles in a fixed order. No
// float atomics: the result is deterministic. B8 takes any Cin and Cout: K is
// zero-padded to the chunk depth (16) and ragged channel and pixel counts
// are masked; no divisibility is asked.
#include "conv_tiles.cuh"
#include "hopper.cuh"

namespace {

struct Conv {
  const void* x;        // (B, H, W, Cin)
  const void* wt;       // (9 * Cin, Cout) row-major
  const float* pscale;  // B6 prologue relu(pscale * x + pbias), (Cin,); unused without PRO
  const float* pbias;
  const float* bias;    // B8 epilogue bias (Cout,) f32
  void* y;              // (B, H, W, Cout)
  float* partials;      // B6: (m tiles, 2, Cout) f32
  long long m;          // B * H * W
  int h, w, cin, cout;
  bool x_vec, w_vec;    // 16-byte loads allowed along the channels of x / w
};

enum Epi { kStats = 0, kBias = 1, kBiasRelu = 2 };

template <typename T, bool PRO>
__device__ __forceinline__ uint4 load_a_vec(const Conv& c, const Pixel& p, int kc, int tap,
                                            int c0, bool slot) {
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const int ci = c0 + kc;
  const int valid = slot ? shifted_valid(p, dh, dw, c.h, c.w, ci, c.cin) : 0;
  if (valid <= 0) return make_uint4(0u, 0u, 0u, 0u);
  const T* src = static_cast<const T*>(c.x) + (p.m + dh * c.w + dw) * c.cin + ci;
  const uint4 r = load_vec<T>(src, valid, c.x_vec);
  return PRO ? affine_relu<T>(r, c.pscale + ci, c.pbias + ci, valid) : r;
}

template <typename T>
__device__ __forceinline__ uint4 load_b_vec(const Conv& c, int k, int n, int tap, bool slot) {
  const int valid = slot && k < c.cin ? c.cout - n : 0;
  if (valid <= 0) return make_uint4(0u, 0u, 0u, 0u);
  const long long row = static_cast<long long>(tap) * c.cin + k;
  const T* src = static_cast<const T*>(c.wt) + row * c.cout + n;
  return load_vec<T>(src, valid, c.w_vec);
}

template <int EPI>
__device__ __forceinline__ float epilogue(const Conv& c, float v, int n) {
  if (EPI != kStats) v += __ldg(c.bias + n);
  if (EPI == kBiasRelu) v = fmaxf(v, 0.f);
  return v;
}

// ======================================================= bf16: tensor cores

// Two blocks per SM (at most 128 registers a thread; B6's 128x128 tile
// spills 8 bytes) hide more of a chunk's load latency than one block of 165.
template <int BM, int BN, int BK, int WM, int WN, int EPI, bool PRO>
__global__ void __launch_bounds__(32 * WM * WN, 2)
tc_conv3x3(const Conv c) {
  constexpr int NT = 32 * WM * WN;
  constexpr int MI = BM / WM / 16, NI = BN / WN / 8;
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int AV = BM * BK / 8, BV = BK * BN / 8;  // 16-byte vectors per tile
  constexpr int AS = (AV + NT - 1) / NT, BS = (BV + NT - 1) / NT;
  static_assert(NI % 2 == 0 && BK % 16 == 0 && BM % (16 * WM) == 0, "tile shape");
  __shared__ __align__(16) bf16 as[2][BM * LDA];
  __shared__ __align__(16) bf16 bs[2][BK * LDB];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int wm0 = (warp % WM) * (BM / WM), wn0 = (warp / WM) * (BN / WN);

  Pixel pix[AS];
#pragma unroll
  for (int i = 0; i < AS; ++i) {
    const int v = tid + i * NT;
    pix[i] = make_pixel(m0 + v / (BK / 8), c.m, c.h, c.w);
  }
  const int chunks = (c.cin + BK - 1) / BK;
  const int iters = 9 * chunks;
  uint4 ra[AS], rb[BS];

  auto fetch = [&](int it) {
    const int tap = it / chunks, c0 = (it % chunks) * BK;
#pragma unroll
    for (int i = 0; i < AS; ++i) {
      const int v = tid + i * NT;
      ra[i] = load_a_vec<bf16, PRO>(c, pix[i], (v % (BK / 8)) * 8, tap, c0, v < AV);
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int v = tid + i * NT;
      rb[i] = load_b_vec<bf16>(c, c0 + v / (BN / 8), n0 + (v % (BN / 8)) * 8, tap, v < BV);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < AS; ++i) {
      const int v = tid + i * NT;
      if (v < AV)
        *reinterpret_cast<uint4*>(&as[buf][(v / (BK / 8)) * LDA + (v % (BK / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int v = tid + i * NT;
      if (v < BV)
        *reinterpret_cast<uint4*>(&bs[buf][(v / (BN / 8)) * LDB + (v % (BN / 8)) * 8]) = rb[i];
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < iters) fetch(it + 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ks::load_a_x4(a[i], as[buf], LDA, wm0 + 16 * i, 16 * kk);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t b[4];
        ks::load_b_trans(b, bs[buf], LDB, 16 * kk, wn0 + 16 * j);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          ks::mma(acc[i][2 * j], a[i], b[0], b[1]);
          ks::mma(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (it + 1 < iters) stash(buf ^ 1);
    __syncthreads();
  }

  // epilogue: C fragment element e of tile (i, j) sits at row
  // 16 i + lane/4 + 8 (e/2), column 8 j + 2 (lane%4) + e%2 of the warp tile
  bf16* y = static_cast<bf16*>(c.y);
  const bool pairs = c.cout % 2 == 0;
  float ssum[NI][2], ssq[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j) ssum[j][0] = ssum[j][1] = ssq[j][0] = ssq[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm0 + 16 * i + lane / 4 + 8 * half;
      if (m >= c.m) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn0 + 8 * j + 2 * (lane % 4);
        if (n >= c.cout) continue;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (EPI == kStats) {
          ssum[j][0] += v0;
          ssq[j][0] = fmaf(v0, v0, ssq[j][0]);
          ssum[j][1] += v1;
          ssq[j][1] = fmaf(v1, v1, ssq[j][1]);
        }
        const float o0 = epilogue<EPI>(c, v0, n);
        bf16* dst = y + m * c.cout + n;
        if (n + 1 < c.cout) {
          const float o1 = epilogue<EPI>(c, v1, n + 1);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(dst) = ks::pack(o0, o1);
          } else {
            dst[0] = __float2bfloat16_rn(o0);
            dst[1] = __float2bfloat16_rn(o1);
          }
        } else {
          dst[0] = __float2bfloat16_rn(o0);
        }
      }
    }
  }
  if constexpr (EPI == kStats) {
    // column sums over the warp's rows (lanes with one lane%4), then over the
    // WM warps of a column band in order
    __shared__ float red[WM][2][BN];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = ssum[j][e], q = ssq[j][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (lane < 4) {
          const int col = wn0 + 8 * j + 2 * lane + e;
          red[warp % WM][0][col] = s;
          red[warp % WM][1][col] = q;
        }
      }
    __syncthreads();
    for (int t = tid; t < 2 * BN; t += NT) {
      const int s = t / BN, col = t % BN;
      float v = 0.f;
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) v += red[wm][s][col];
      if (n0 + col < c.cout)
        c.partials[(static_cast<long long>(blockIdx.x) * 2 + s) * c.cout + n0 + col] = v;
    }
  }
}

// ================================================= bf16 on Hopper: wgmma

// B6 without the prologue: see the note at the top. kWgNWG warpgroups, BM =
// 192 pixels x 128 output channels; Cin % 64 == 0, Cout % 128 == 0.
// xmap: x as (B*H*W, Cin) in boxes of BM pixels x 64 channels; wmap: w as
// (9*Cin, Cout) in boxes of 64 rows x 64 channels.
constexpr int kStages = 5;  // ring depth: 5 x 40 KB
constexpr int kWgNWG = 3, kWgBM = 64 * kWgNWG;

__global__ void __launch_bounds__(128 * kWgNWG, 1)
wgmma_conv3x3(const Conv c, const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap) {
  constexpr int NWG = kWgNWG, BM = kWgBM, NT = 128 * NWG, BN = 128;
  constexpr int AS = BM * 8 / NT;  // A rows a thread checks per chunk
  extern __shared__ __align__(1024) uint8_t dyn[];
  const uint32_t raw = hopper::smem_addr(dyn), ring = (raw + 1023) & ~1023u;
  float* red =
      reinterpret_cast<float*>(dyn + (ring - raw) + hopper::ring_bytes<NWG, kStages>() - 1024);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  // A's rows are this tile's BM pixels shifted by the tap; this thread
  // checks chunk tid % 8 of rows tid / 8 + i NT / 8 for the halo
  int ph[AS], pw[AS];
  bool live[AS];
  uint32_t aoff[AS];
#pragma unroll
  for (int i = 0; i < AS; ++i) {
    const int row = tid / 8 + i * (NT / 8);
    const Pixel p = make_pixel(m0 + row, c.m, c.h, c.w);
    ph[i] = p.h;
    pw[i] = p.w;
    live[i] = p.live;
    aoff[i] = hopper::b128_offset(row, tid % 8);
  }
  // K runs tap-minor: chunk it is tap it % 9 of input channels 64 (it / 9)
  auto issue = [&](int it, uint32_t a, uint32_t b, uint32_t bar) {
    const int tap = it % 9, c0 = (it / 9) * 64, k = tap * c.cin + c0;
    hopper::mbar_arrive_expect_tx(bar, BM * 128 + hopper::kTileB);
    hopper::tma_load_2d(a, xmap, c0, static_cast<int>(m0) + (tap / 3 - 1) * c.w + tap % 3 - 1,
                        bar);
    hopper::tma_load_2d(b, wmap, n0, k, bar);
    hopper::tma_load_2d(b + 8192, wmap, n0 + 64, k, bar);
  };
  // the box read each row's pixel shifted in memory; where the shifted pixel
  // lies outside the image (the halo), the row must read as 0
  auto fixup = [&](int it, uint32_t a) {
    const int dh = it % 9 / 3 - 1, dw = it % 3 - 1;
#pragma unroll
    for (int i = 0; i < AS; ++i) {
      const int hh = ph[i] + dh, ww = pw[i] + dw;
      if (!(live[i] && hh >= 0 && hh < c.h && ww >= 0 && ww < c.w))
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a + aoff[i]), "r"(0)
                     : "memory");
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hopper::ring_gemm<NWG, kStages, 0>(acc, ring, 9 * (c.cin / 64), issue, fixup);

  // epilogue: this thread holds rows r0 and r0 + 8, columns 8 j + 2 (lane%4)
  // (+1) of the block tile (hopper.cuh: wgmma_m64n128k16)
  const long long r0 = m0 + warp * 16 + lane / 4;
  const bool ok0 = r0 < c.m, ok1 = r0 + 8 < c.m;
  bf16* y0 = static_cast<bf16*>(c.y) + r0 * c.cout + n0 + 2 * (lane % 4);
  bf16* y1 = y0 + 8LL * c.cout;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float* v = acc + 4 * j;
    if (ok0) *reinterpret_cast<uint32_t*>(y0 + 8 * j) = ks::pack(v[0], v[1]);
    if (ok1) *reinterpret_cast<uint32_t*>(y1 + 8 * j) = ks::pack(v[2], v[3]);
    float s[2], q[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = ok0 ? v[e] : 0.f, b = ok1 ? v[2 + e] : 0.f;
      s[e] = a + b;
      q[e] = fmaf(b, b, a * a);
    }
    // column sums over the warp's rows (lanes with one lane%4)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
        q[e] += __shfl_xor_sync(0xffffffffu, q[e], off);
      }
    if (lane < 4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(warp * 2) * BN + 8 * j + 2 * lane + e] = s[e];
        red[(warp * 2 + 1) * BN + 8 * j + 2 * lane + e] = q[e];
      }
  }
  __syncthreads();
  // then over the block's warps in order
  for (int t = tid; t < 2 * BN; t += NT) {
    const int st = t / BN, col = t % BN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < BM / 16; ++w) v += red[(w * 2 + st) * BN + col];
    c.partials[(static_cast<long long>(blockIdx.x) * 2 + st) * c.cout + n0 + col] = v;
  }
}

// ======================================================= f32: CUDA-core FMA

constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16, kSimtThreads = 256;

template <int EPI, bool PRO>
__global__ void __launch_bounds__(kSimtThreads)
simt_conv3x3(const Conv c) {
  constexpr int BM = kSimtBM, BN = kSimtBN, BK = kSimtBK;
  // one 4-float vector of A and of B per thread and chunk
  static_assert(BM * BK / 4 == kSimtThreads && BK * BN / 4 == kSimtThreads, "tile shape");
  __shared__ __align__(16) float as[2][BK][BM];  // k-major: as[k][pixel]
  __shared__ __align__(16) float bs[2][BK][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int arow = tid / (BK / 4), akc = (tid % (BK / 4)) * 4;
  const int bk = tid / (BN / 4), bnc = (tid % (BN / 4)) * 4;
  const Pixel pix = make_pixel(m0 + arow, c.m, c.h, c.w);
  const int chunks = (c.cin + BK - 1) / BK;
  const int iters = 9 * chunks;
  uint4 ra, rb;
  auto fetch = [&](int it) {
    const int tap = it / chunks, c0 = (it % chunks) * BK;
    ra = load_a_vec<float, PRO>(c, pix, akc, tap, c0, true);
    rb = load_b_vec<float>(c, c0 + bk, n0 + bnc, tap, true);
  };
  auto stash = [&](int buf) {
    const float* a = reinterpret_cast<const float*>(&ra);
#pragma unroll
    for (int j = 0; j < 4; ++j) as[buf][akc + j][arow] = a[j];
    *reinterpret_cast<uint4*>(&bs[buf][bk][bnc]) = rb;
  };
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < iters) fetch(it + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[buf][k][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[buf][k][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    if (it + 1 < iters) stash(buf ^ 1);
    __syncthreads();
  }

  float* y = static_cast<float*>(c.y);
  float ssum[4] = {0.f, 0.f, 0.f, 0.f}, ssq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + ty + 16 * r;
    if (m >= c.m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n >= c.cout) continue;
      const float v = acc[r][q];
      ssum[q] += v;
      ssq[q] = fmaf(v, v, ssq[q]);
      y[m * c.cout + n] = epilogue<EPI>(c, v, n);
    }
  }
  if constexpr (EPI == kStats) {
    __shared__ float red[16][2][BN];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[ty][0][tx + 16 * q] = ssum[q];
      red[ty][1][tx + 16 * q] = ssq[q];
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int s = tid / BN, col = tid % BN;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) v += red[r][s][col];
      if (n0 + col < c.cout)
        c.partials[(static_cast<long long>(blockIdx.x) * 2 + s) * c.cout + n0 + col] = v;
    }
  }
}

// stats[c] = sum over pixel tiles t of partials[t, c], c over the 2 Cout
// [sum y, sum y^2] columns, in a fixed order: kFoldGroups groups of tiles
// (t = g mod kFoldGroups), each summed in order of t, then the group sums
// in order of g. A block folds 32 columns; the groups put more loads in
// flight than one thread walking every tile of a column would.
constexpr int kFoldGroups = 8;

__global__ void __launch_bounds__(32 * kFoldGroups)
stats_fold(const float* __restrict__ partials, float* __restrict__ stats, int tiles, int cout) {
  __shared__ float group[kFoldGroups][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (c < 2 * cout) {
#pragma unroll 4
    for (int t = g; t < tiles; t += kFoldGroups)
      v += partials[static_cast<long long>(t) * 2 * cout + c];
  }
  group[g][lane] = v;
  __syncthreads();
  if (g == 0 && c < 2 * cout) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < kFoldGroups; ++i) r += group[i][lane];
    stats[c] = r;
  }
}

// The kernels; the wrapper's plan (ops/conv_bn.py: conv3x3_plan) names one
// of them for each call, and sizes B6's partials by its pixel tile.
enum Kernel { kSimt = 0, kMmaSync = 1, kWgmma = 2 };
constexpr int kTcBM = 128;

// whether `kernel` computes this call: the one check of the plan
bool takes(int kernel, bool bf16, bool stats_no_pro, int cin, int cout) {
  switch (kernel) {
    case kSimt: return !bf16;
    case kMmaSync: return bf16;
    case kWgmma: return bf16 && stats_no_pro && cin % 64 == 0 && cout % 128 == 0;
    default: return false;
  }
}

// output pixels a block of `kernel` owns (ops/conv_bn.py: PIXEL_TILE)
int tile_of(int kernel) { return kernel == kSimt ? kSimtBM : kernel == kMmaSync ? kTcBM : kWgBM; }

dim3 grid_of(const Conv& c, int bm, int bn) {
  return dim3(static_cast<unsigned>((c.m + bm - 1) / bm), (c.cout + bn - 1) / bn);
}

cudaError_t launch_wgmma(const Conv& c, cudaStream_t s) {
  constexpr int bytes = hopper::ring_bytes<kWgNWG, kStages>() + (kWgBM / 16) * 2 * 128 * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_conv3x3, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap xmap, wmap;
  if (hopper::encode_bf16_rows(&xmap, c.x, c.m, c.cin, kWgBM) ||
      hopper::encode_bf16_rows(&wmap, c.wt, 9LL * c.cin, c.cout, 64))
    return cudaErrorInvalidValue;
  wgmma_conv3x3<<<grid_of(c, kWgBM, 128), 128 * kWgNWG, bytes, s>>>(c, xmap, wmap);
  return cudaGetLastError();
}

template <int EPI, bool PRO>
cudaError_t launch(const Conv& c, int kernel, cudaStream_t s) {
  if (kernel == kSimt) {
    simt_conv3x3<EPI, PRO><<<grid_of(c, kSimtBM, kSimtBN), kSimtThreads, 0, s>>>(c);
  } else if (kernel == kWgmma) {
    if constexpr (EPI == kStats && !PRO) return launch_wgmma(c, s);
    return cudaErrorInvalidValue;
  } else if constexpr (EPI == kStats) {
    tc_conv3x3<kTcBM, 128, 32, 4, 2, EPI, PRO><<<grid_of(c, kTcBM, 128), 256, 0, s>>>(c);
  } else if (c.cout <= 16) {  // B8: narrow N tiles, K in chunks of 16 channels
    tc_conv3x3<kTcBM, 16, 16, 8, 1, EPI, false><<<grid_of(c, kTcBM, 16), 256, 0, s>>>(c);
  } else {
    tc_conv3x3<kTcBM, 32, 16, 8, 1, EPI, false><<<grid_of(c, kTcBM, 32), 256, 0, s>>>(c);
  }
  return cudaGetLastError();
}

Conv make_conv(const void* x, const void* w, void* y, long long m, int h, int w_, int cin,
               int cout, bool is_bf16) {
  const int v = is_bf16 ? 8 : 4;
  Conv c{};
  c.x = x;
  c.wt = w;
  c.y = y;
  c.m = m;
  c.h = h;
  c.w = w_;
  c.cin = cin;
  c.cout = cout;
  c.x_vec = cin % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  c.w_vec = cout % v == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return c;
}

}  // namespace

// B6. x (B, H, W, Cin) and w (9*Cin, Cout), both f32 or both bf16,
// contiguous and 16-byte aligned; scale, bias (Cin,) f32 or both null (no
// prologue); y (B, H, W, Cout) in x's dtype; partials (ceil(m / tile), 2,
// Cout) f32 scratch, tile the kernel's pixel tile (tile_of); stats (2, Cout)
// f32. m = B*H*W. kernel (Kernel) from the wrapper's plan;
// cudaErrorInvalidValue, and nothing launched, when it does not take the
// call.
extern "C" int ks_conv3x3_bn_stats(const void* x, const void* w, const void* scale,
                                   const void* bias, void* y, void* partials, void* stats,
                                   long long m, int h, int w_, int cin, int cout, int is_bf16,
                                   int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, scale == nullptr, cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  Conv c = make_conv(x, w, y, m, h, w_, cin, cout, is_bf16 != 0);
  c.pscale = static_cast<const float*>(scale);
  c.pbias = static_cast<const float*>(bias);
  c.partials = static_cast<float*>(partials);
  const cudaError_t err = scale != nullptr ? launch<kStats, true>(c, kernel, s)
                                           : launch<kStats, false>(c, kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = static_cast<int>((m + tile_of(kernel) - 1) / tile_of(kernel));
  stats_fold<<<(2 * cout + 31) / 32, 32 * kFoldGroups, 0, s>>>(
      c.partials, static_cast<float*>(stats), tiles, cout);
  return static_cast<int>(cudaGetLastError());
}

// B8. x (B, H, W, Cin) and w (9*Cin, Cout), both f32 or both bf16,
// contiguous; bias (Cout,) f32; y (B, H, W, Cout) in x's dtype; kernel as
// for B6 (simt or mma_sync).
extern "C" int ks_conv3x3_bias_act(const void* x, const void* w, const void* bias, void* y,
                                   long long m, int h, int w_, int cin, int cout, int relu,
                                   int is_bf16, int kernel, void* stream) {
  if (!takes(kernel, is_bf16 != 0, false, cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  Conv c = make_conv(x, w, y, m, h, w_, cin, cout, is_bf16 != 0);
  c.bias = static_cast<const float*>(bias);
  return static_cast<int>(relu ? launch<kBiasRelu, false>(c, kernel, s)
                               : launch<kBias, false>(c, kernel, s));
}
