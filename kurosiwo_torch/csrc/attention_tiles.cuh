// Tile building blocks of the attention kernels (short_attention.cu, B4, and
// flash_attention.cu, B5): 64-row query and key tiles, an f32 path on CUDA-core
// FMA (256 threads, [64][D + 1] f32 tiles) and a bf16 path on tensor cores
// (mma.sync m16n8k16 with f32 accumulators, 4 warps of 16 rows, [64][D + 8]
// bf16 tiles). Each .cu that includes this header is its own library, so the
// helpers sit in the including file's anonymous namespace (and its `simt` and
// `tc` namespaces), where its kernels find them unqualified.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows of a query or key tile

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

}  // namespace simt

// ===================================================================== bf16

namespace tc {

constexpr int kWarps = 4;  // 16 rows of the 64-row tile each
constexpr int kThreads = 32 * kWarps;

using ks::load_a;
using ks::load_b_trans;
using ks::load_b_x4;
using ks::mma;
using ks::pack;

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

// s (16 x 64) += A . B^T over columns [16 ks, 16 ks + 16) of D: A the 16-row
// fragment a, B the 64 rows of tile b
template <int D>
__device__ __forceinline__ void scores_step(float (&s)[8][4], const uint32_t (&a)[4],
                                            const bf16* b, int ks) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t fb[4];
    load_b_x4(fb, b, D + 8, 16 * np, 16 * ks);
    mma(s[2 * np], a, fb[0], fb[1]);
    mma(s[2 * np + 1], a, fb[2], fb[3]);
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
    scores_step<D>(s, fa, b, ks);
  }
}

}  // namespace tc

}  // namespace
