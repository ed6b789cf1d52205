// B7: weight gradient of a 3x3 SAME stride-1 convolution on NHWC,
//   dW[tap][ci][co] = sum over pixels p of x[p shifted by tap][ci] * dy[p][co],
// (3, 3, Cin, Cout) f32. Replaces the TPU kernel
// kurosiwo_tpu/ops/pallas_dw.py::_dw_kernel (:48; conv3x3_dw, launched at
// :105).
//
// GEMM per tap: M = Cin, N = Cout, K = B*H*W pixels (100,352 at the UNet's
// 28x28 level, batch 128). The TPU kernel pads x and dy into one flat
// geometry so each tap is a constant row offset, and carries the (9, Cin,
// Cout) sum in VMEM across a sequential grid over batch blocks. Here a block
// owns one (tap, Cin tile, Cout tile) and one slice of K: it reads the dy
// pixels of its slice and the x pixels shifted by the tap, masking those
// outside the image to 0 (no padded copies). Without a split of K there would
// be only 9 x (Cin/128) x (Cout/128) blocks for the card's 132 SMs, so K is
// cut into slices (ops/conv_dw.py: conv3x3_dw_plan picks how many, from the
// waves of blocks over the SMs against the partials' traffic), each slice
// writes f32 partials, and a second launch sums the slices in order:
// deterministic, no float atomics.
//
// Bound on an H100: 2 * 9 * Cin * Cout * K operations (29.6 GFLOP at 128 ->
// 128, 88.8 at 384 -> 128) over 51-103 MB: operations (989 TFLOP/s bf16).
//
// Design:
//  * bf16: wgmma_conv_dw, Hopper's warpgroup products. Two warpgroups own
//    64 input channels each of a 128 x 128 (Cin x Cout) tile and issue
//    wgmma m64n128k16 on both operands as they lie in memory: pixel rows of
//    x (shifted) and of dy, Cin or Cout along the row, i.e. MN-major
//    128-byte-swizzled tiles, read through the descriptors' transpose bits.
//    They arrive by TMA (hopper.cuh: ring_gemm) through a ring of 5 stages,
//    three chunks of 64 pixels ahead, completion counted on one mbarrier a
//    stage: one barrier per chunk, no per-thread address arithmetic or
//    register staging, at most one wgmma group in flight. Pixels past
//    B*H*W and channels past Cin or Cout read as 0 (so any Cin and Cout
//    that are multiples of 8 run on it); x rows whose shifted pixel left
//    the image are zeroed in shared memory before the product, each thread
//    walking its rows' (h, w) from chunk to chunk without a division.
//  * f32: simt_conv_dw, CUDA-core FMA (64x64 tiles, 4x4 per thread, two
//    shared buffers with the next chunk's loads in registers), so f32
//    results match the CPU's f32 with TF32 off.
#include "conv_tiles.cuh"
#include "hopper.cuh"

namespace {

struct Dw {
  const void* x;    // (B, H, W, Cin)
  const void* dy;   // (B, H, W, Cout)
  float* partials;  // (splits, 9, Cin, Cout) f32
  long long p;      // B * H * W
  long long chunk;  // pixels per K slice, a multiple of the chunk depth
  int h, w, cin, cout, mtiles;
  bool x_vec, dy_vec;
};

constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16, kSimtThreads = 256;
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64;  // wgmma tile: Cin x Cout x pixels a chunk

struct Tile {
  int tap, ci0, co0;
  long long k0, k1;  // this block's pixel slice [k0, k1)
};

__device__ __forceinline__ Tile tile_of(const Dw& d, int bm, int bn) {
  Tile t;
  const int i = blockIdx.y;
  t.tap = i % 9;
  t.ci0 = (i / 9) % d.mtiles * bm;
  t.co0 = i / (9 * d.mtiles) * bn;
  t.k0 = blockIdx.x * d.chunk;
  t.k1 = t.k0 + d.chunk < d.p ? t.k0 + d.chunk : d.p;
  return t;
}

// 16 bytes of x at pixel p shifted by the tap, channels [ci, ci + V)
template <typename T>
__device__ __forceinline__ uint4 load_x(const Dw& d, const Tile& t, const Pixel& p, int ci) {
  const int dh = t.tap / 3 - 1, dw = t.tap % 3 - 1;
  const int valid = ci < d.cin ? shifted_valid(p, dh, dw, d.h, d.w, ci, d.cin) : 0;
  if (valid <= 0) return make_uint4(0u, 0u, 0u, 0u);
  return load_vec<T>(static_cast<const T*>(d.x) + (p.m + dh * d.w + dw) * d.cin + ci, valid,
                     d.x_vec);
}

// 16 bytes of dy at pixel k, channels [co, co + V)
template <typename T>
__device__ __forceinline__ uint4 load_dy(const Dw& d, const Tile& t, long long k, int co) {
  const int valid = k < t.k1 ? d.cout - co : 0;
  if (valid <= 0) return make_uint4(0u, 0u, 0u, 0u);
  return load_vec<T>(static_cast<const T*>(d.dy) + k * d.cout + co, valid, d.dy_vec);
}

__device__ __forceinline__ float* partial_row(const Dw& d, int tap, int ci) {
  return d.partials + ((static_cast<long long>(blockIdx.x) * 9 + tap) * d.cin + ci) * d.cout;
}

// ================================================= bf16 on Hopper: wgmma

// xmap, dymap: x as (B*H*W, Cin) and dy as (B*H*W, Cout) in boxes of 64
// pixels x 64 channels.
constexpr int kStages = 5;  // ring depth: 5 x 32 KB

__global__ void __launch_bounds__(256, 1)
wgmma_conv_dw(const Dw d, const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap dymap) {
  extern __shared__ __align__(1024) uint8_t dyn[];
  const uint32_t ring = (hopper::smem_addr(dyn) + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Tile t = tile_of(d, kWgBM, kWgBN);
  const int chunks = t.k1 > t.k0 ? static_cast<int>((t.k1 - t.k0 + kWgBK - 1) / kWgBK) : 0;
  const int dh = t.tap / 3 - 1, dw = t.tap % 3 - 1;
  // A (x shifted) and B (dy): 64 pixel rows of 16 chunks (two 64-column
  // blocks). This thread checks chunk tid % 16 of A's rows tid / 16 + 16 i
  // for the halo, walking those pixels' (h, w) from chunk to chunk.
  Pixel px[4];
  uint32_t off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tid / 16 + 16 * i;
    px[i] = make_pixel(t.k0 + r, t.k1, d.h, d.w);
    off[i] = (tid % 16 / 8) * 8192 + hopper::b128_offset(r, tid % 8);
  }
  // slices are whole chunks, so a box never reaches into the next slice;
  // rows past B*H*W and channels past Cin or Cout read as 0
  auto issue = [&](int it, uint32_t a, uint32_t b, uint32_t bar) {
    const int k = static_cast<int>(t.k0) + it * kWgBK, xk = k + dh * d.w + dw;
    hopper::mbar_arrive_expect_tx(bar, 2 * hopper::kTileB);
    hopper::tma_load_2d(a, xmap, t.ci0, xk, bar);
    hopper::tma_load_2d(a + 8192, xmap, t.ci0 + 64, xk, bar);
    hopper::tma_load_2d(b, dymap, t.co0, k, bar);
    hopper::tma_load_2d(b + 8192, dymap, t.co0 + 64, k, bar);
  };
  // where a row's shifted pixel lies outside the image, its x row reads as 0
  auto fixup = [&](int, uint32_t a) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Pixel& p = px[i];
      const int hh = p.h + dh, ww = p.w + dw;
      if (!(p.live && hh >= 0 && hh < d.h && ww >= 0 && ww < d.w))
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a + off[i]), "r"(0)
                     : "memory");
      advance(p, kWgBK, t.k1, d.h, d.w);
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hopper::ring_gemm<2, kStages, 1>(acc, ring, chunks, issue, fixup);

  // this thread holds Cin rows r0 and r0 + 8, Cout columns 8 j + 2 (lane%4)
  // (+1) of the tile (hopper.cuh: wgmma_m64n128k16). Cin and Cout are
  // multiples of 8, so a column pair is in or out as a whole.
  const int r0 = t.ci0 + warp * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= d.cin) continue;
    float* row = partial_row(d, t.tap, r0 + 8 * h);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.co0 + 8 * j + 2 * (lane % 4);
      if (col < d.cout)
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ======================================================= f32: CUDA-core FMA

__global__ void __launch_bounds__(kSimtThreads)
simt_conv_dw(const Dw d) {
  constexpr int BM = kSimtBM, BN = kSimtBN, BK = kSimtBK;
  static_assert(BK * BM / 4 == kSimtThreads && BK * BN / 4 == kSimtThreads, "tile shape");
  __shared__ __align__(16) float xs[2][BK][BM];
  __shared__ __align__(16) float ds[2][BK][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const Tile t = tile_of(d, BM, BN);
  const int xk = tid / (BM / 4), xc = (tid % (BM / 4)) * 4;
  const int dk = tid / (BN / 4), dc = (tid % (BN / 4)) * 4;
  const int iters = t.k1 > t.k0 ? static_cast<int>((t.k1 - t.k0 + BK - 1) / BK) : 0;
  uint4 ra, rb;
  Pixel px = make_pixel(t.k0 + xk, t.k1, d.h, d.w);
  auto fetch = [&](int it) {
    const long long k0 = t.k0 + static_cast<long long>(it) * BK;
    ra = load_x<float>(d, t, px, t.ci0 + xc);
    advance(px, BK, t.k1, d.h, d.w);
    rb = load_dy<float>(d, t, k0 + dk, t.co0 + dc);
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<uint4*>(&xs[buf][xk][xc]) = ra;
    *reinterpret_cast<uint4*>(&ds[buf][dk][dc]) = rb;
  };
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  if (iters > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < iters) fetch(it + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = xs[buf][k][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = ds[buf][k][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    if (it + 1 < iters) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ci = t.ci0 + ty + 16 * r;
    if (ci >= d.cin) continue;
    float* row = partial_row(d, t.tap, ci);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = t.co0 + tx + 16 * q;
      if (co < d.cout) row[co] = acc[r][q];
    }
  }
}

// out[i] = sum over slices s (in order) of partials[s, i], i over 9*Cin*Cout
__global__ void dw_fold(const float* __restrict__ partials, float* __restrict__ out,
                        long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partials[s * n + i];
  out[i] = v;
}

// the kernels; the wrapper's plan (ops/conv_dw.py: conv3x3_dw_plan) names
// one of them for each call, with its K split
enum Kernel { kSimt = 0, kWgmma = 1 };

}  // namespace

// x (B, H, W, Cin) and dy (B, H, W, Cout), both f32 or both bf16, contiguous
// and 16-byte aligned, Cin and Cout multiples of 8; partials (splits, 9, Cin,
// Cout) f32 scratch; out (3, 3, Cin, Cout) f32. p = B*H*W. kernel (Kernel),
// splits and slice (pixels a block sums) from the wrapper's plan: the one
// check of the plan is here. bf16 takes kWgmma and f32 kSimt, and slice is
// a multiple of the kernel's chunk (64 for bf16, 16 for f32) with splits *
// slice >= p; cudaErrorInvalidValue, and nothing launched, otherwise.
extern "C" int ks_conv3x3_dw(const void* x, const void* dy, void* partials, void* out,
                             long long p, int h, int w, int cin, int cout, int is_bf16,
                             int kernel, int splits, long long slice, void* stream) {
  const bool bf = is_bf16 != 0;
  const int bm = bf ? kWgBM : kSimtBM, bn = bf ? kWgBN : kSimtBN, bk = bf ? kWgBK : kSimtBK;
  if (kernel != (bf ? kWgmma : kSimt) || splits < 1 || slice < bk || slice % bk ||
      splits * slice < p)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = bf ? 8 : 4;
  Dw d{};
  d.x = x;
  d.dy = dy;
  d.partials = static_cast<float*>(partials);
  d.p = p;
  d.chunk = slice;
  d.h = h;
  d.w = w;
  d.cin = cin;
  d.cout = cout;
  d.mtiles = (cin + bm - 1) / bm;
  d.x_vec = cin % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  d.dy_vec = cout % v == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const dim3 grid(splits, 9 * d.mtiles * ((cout + bn - 1) / bn));
  if (bf) {
    constexpr int bytes = hopper::ring_bytes<2, kStages>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        wgmma_conv_dw, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    CUtensorMap xmap, dymap;
    if (hopper::encode_bf16_rows(&xmap, x, p, cin, 64) ||
        hopper::encode_bf16_rows(&dymap, dy, p, cout, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    wgmma_conv_dw<<<grid, 256, bytes, s>>>(d, xmap, dymap);
  } else {
    simt_conv_dw<<<grid, kSimtThreads, 0, s>>>(d);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 9LL * cin * cout;
  dw_fold<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      d.partials, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
