// B7: weight gradient of a 3x3 SAME stride-1 convolution on NHWC,
//   dW[tap][ci][co] = sum over pixels p of x[p shifted by tap][ci] * dy[p][co],
// (3, 3, Cin, Cout) f32. Replaces the TPU kernel
// kurosiwo_tpu/ops/pallas_dw.py::_dw_kernel (conv3x3_dw, launched at :105).
//
// GEMM per tap: M = Cin, N = Cout, K = B*H*W pixels (100,352 at the UNet's
// 28x28 level, batch 128). The TPU kernel pads x and dy into one flat
// geometry so each tap is a constant row offset, and carries the (9, Cin,
// Cout) sum in VMEM across a sequential grid over batch blocks. Here a block
// owns one (tap, Cin tile, Cout tile) and one slice of K: it reads the dy
// pixels of its slice and the x pixels shifted by the tap, masking those
// outside the image to 0 (no padded copies). Without a split of K there would
// be only 9 x (Cin/128) x (Cout/128) blocks for the card's 132 SMs, so K is
// cut into slices (about two blocks per SM in all), each slice writes f32
// partials, and a second launch sums the slices in order: deterministic, no
// float atomics.
//
// Bound on an H100: 2 * 9 * Cin * Cout * K operations (29.6 GFLOP at 128 ->
// 128, 88.8 at 384 -> 128) over 51-103 MB: operations (989 TFLOP/s bf16).
//
// Design: bf16 on tensor cores (mma.sync m16n8k16, f32 accumulators); both
// operands are stored pixel-major in shared memory ([BK][BM+8] x rows and
// [BK][BN+8] dy rows, as they arrive from global memory), so A fragments come
// from ldmatrix.x4.trans and B fragments from ldmatrix.x4.trans. f32 on
// CUDA-core FMA (64x64 tiles, 4x4 per thread). Two shared-memory buffers
// with the next slice chunk's loads in registers during the products.
#include "conv_tiles.cuh"

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

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32, kTcWM = 4, kTcWN = 2;
constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16, kSimtThreads = 256;
constexpr int kTargetBlocks = 2 * 132;  // about two blocks on each of the H100's SMs

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

// ======================================================= bf16: tensor cores

// Two blocks per SM (at most 128 registers a thread, 8 bytes spill) hide
// more of a chunk's load latency than one block of 167.
__global__ void __launch_bounds__(32 * kTcWM * kTcWN, 2)
tc_conv_dw(const Dw d) {
  constexpr int BM = kTcBM, BN = kTcBN, BK = kTcBK, WM = kTcWM, WN = kTcWN;
  constexpr int NT = 32 * WM * WN;
  constexpr int MI = BM / WM / 16, NI = BN / WN / 8;
  constexpr int LDA = BM + 8, LDB = BN + 8;
  constexpr int AS = BK * BM / 8 / NT, BS = BK * BN / 8 / NT;  // 16-byte vectors per thread
  static_assert(BK * BM / 8 % NT == 0 && BK * BN / 8 % NT == 0 && NI % 2 == 0, "tile shape");
  __shared__ __align__(16) bf16 xs[2][BK * LDA];  // row k = pixel, Cin along the row
  __shared__ __align__(16) bf16 ds[2][BK * LDB];  // row k = pixel, Cout along the row

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Tile t = tile_of(d, BM, BN);
  const int wm0 = (warp % WM) * (BM / WM), wn0 = (warp / WM) * (BN / WN);
  const int iters = t.k1 > t.k0 ? static_cast<int>((t.k1 - t.k0 + BK - 1) / BK) : 0;
  uint4 ra[AS], rb[BS];
  // each load slot's x pixel, walked BK pixels on per chunk (no division)
  Pixel px[AS];
#pragma unroll
  for (int i = 0; i < AS; ++i)
    px[i] = make_pixel(t.k0 + (tid + i * NT) / (BM / 8), t.k1, d.h, d.w);
  auto fetch = [&](int it) {
    const long long k0 = t.k0 + static_cast<long long>(it) * BK;
#pragma unroll
    for (int i = 0; i < AS; ++i) {
      const int v = tid + i * NT;
      ra[i] = load_x<bf16>(d, t, px[i], t.ci0 + (v % (BM / 8)) * 8);
      advance(px[i], BK, t.k1, d.h, d.w);
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int v = tid + i * NT;
      rb[i] = load_dy<bf16>(d, t, k0 + v / (BN / 8), t.co0 + (v % (BN / 8)) * 8);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < AS; ++i) {
      const int v = tid + i * NT;
      *reinterpret_cast<uint4*>(&xs[buf][(v / (BM / 8)) * LDA + (v % (BM / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const int v = tid + i * NT;
      *reinterpret_cast<uint4*>(&ds[buf][(v / (BN / 8)) * LDB + (v % (BN / 8)) * 8]) = rb[i];
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (iters > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < iters) fetch(it + 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ks::load_a_trans(a[i], xs[buf], LDA, 16 * kk, wm0 + 16 * i);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t b[4];
        ks::load_b_trans(b, ds[buf], LDB, 16 * kk, wn0 + 16 * j);
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

  // C fragment element e of tile (i, j): Cin row 16 i + lane/4 + 8 (e/2),
  // Cout column 8 j + 2 (lane%4) + e%2 of the warp tile. Cin and Cout are
  // multiples of 8, so a column pair is in or out as a whole.
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = t.ci0 + wm0 + 16 * i + lane / 4 + 8 * half;
      if (ci >= d.cin) continue;
      float* row = partial_row(d, t.tap, ci);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int co = t.co0 + wn0 + 8 * j + 2 * (lane % 4);
        if (co < d.cout)
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
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

struct Plan {
  int bm, bn, bk, mtiles, splits;
  long long chunk;
};

Plan plan(long long p, int cin, int cout, bool is_bf16) {
  Plan pl;
  pl.bm = is_bf16 ? kTcBM : kSimtBM;
  pl.bn = is_bf16 ? kTcBN : kSimtBN;
  pl.bk = is_bf16 ? kTcBK : kSimtBK;
  pl.mtiles = (cin + pl.bm - 1) / pl.bm;
  const int tiles = 9 * pl.mtiles * ((cout + pl.bn - 1) / pl.bn);
  const long long most = (p + 4 * pl.bk - 1) / (4 * pl.bk);  // at least 4 chunks a slice
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  pl.chunk = ((p + splits - 1) / splits + pl.bk - 1) / pl.bk * pl.bk;
  pl.splits = static_cast<int>(splits);
  return pl;
}

}  // namespace

// K slices of a call: the wrapper sizes the partials (splits, 9, Cin, Cout) f32.
extern "C" int ks_conv_dw_splits(long long p, int cin, int cout, int is_bf16) {
  return plan(p, cin, cout, is_bf16 != 0).splits;
}

// x (B, H, W, Cin) and dy (B, H, W, Cout), both f32 or both bf16, contiguous,
// Cin and Cout multiples of 8; partials (splits, 9, Cin, Cout) f32 scratch;
// out (3, 3, Cin, Cout) f32. p = B*H*W.
extern "C" int ks_conv3x3_dw(const void* x, const void* dy, void* partials, void* out,
                             long long p, int h, int w, int cin, int cout, int is_bf16,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const Plan pl = plan(p, cin, cout, bf);
  const int v = bf ? 8 : 4;
  Dw d{};
  d.x = x;
  d.dy = dy;
  d.partials = static_cast<float*>(partials);
  d.p = p;
  d.chunk = pl.chunk;
  d.h = h;
  d.w = w;
  d.cin = cin;
  d.cout = cout;
  d.mtiles = pl.mtiles;
  d.x_vec = cin % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  d.dy_vec = cout % v == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const dim3 grid(pl.splits, 9 * pl.mtiles * ((cout + pl.bn - 1) / pl.bn));
  if (bf) {
    tc_conv_dw<<<grid, 32 * kTcWM * kTcWN, 0, s>>>(d);
  } else {
    simt_conv_dw<<<grid, kSimtThreads, 0, s>>>(d);
  }
  const long long n = 9LL * cin * cout;
  dw_fold<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      d.partials, static_cast<float*>(out), n, pl.splits);
  return static_cast<int>(cudaGetLastError());
}
