// Per-channel (sum(a), sum(a*b)) in f32 over the rows of two (M, C)
// row-major views of channels-last activations: the statistics of every
// BatchNorm (forward: a = b = x; backward: a = dy, b = x).
//
// Replaces the TPU kernel kurosiwo_tpu/ops/pallas_bn.py::_pair_kernel
// (launched by _pair_call, reached through _pair_sums_local / pair_sums).
//
// Bound on an H100 (3.35 TB/s): bytes. Each element is read once and feeds
// one add and one FMA, far below the card's ~300 operations per byte. At
// UNet-ResNet18 batch 128 a forward pass reads 0.72 G bf16 elements over its
// 30 BatchNorms (about 0.43 ms), a backward pass twice that.
//
// Design:
//  * The TPU kernel carries a running sum in scratch from one grid step to
//    the next. Blocks on the card run in no order, so each block instead
//    writes f32 partials for its slab of rows, and a second launch sums the
//    partials in a fixed order: the result is deterministic, with no float
//    atomics.
//  * A block covers 128 columns: 32 lanes x 4 consecutive columns, one 8-byte
//    (bf16) or 16-byte (f32) load per lane and row, so a warp reads whole
//    256/512-byte rows. Its 8 warps take interleaved rows of the slab.
//  * For C dividing 128 the wrapper passes the JAX fold: the tensor viewed
//    as (M*C/128, 128), column l accumulating channel l mod C, folded in the
//    second launch (pallas_bn.py:92-99). Warps then read full rows even at
//    C = 16. Any other C is the (M, C) view itself, cut into 128-column tiles
//    along grid.y; the ragged last tile is masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
pair_partials(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ partials,
              int64_t rows, int width, int64_t rows_per_block) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.y * kTile + lane * 4;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  float s2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t r = r0 + warp; r < r1; r += kWarps) {
    const int64_t base = r * width + col0;
    float va[4], vb[4];
    if (kVec) {
      // width % 4 == 0, so col0 < width means all four columns are in range
      if (col0 >= width) break;
      ks::load4(a + base, va);
      ks::load4(b + base, vb);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = col0 + k < width;
        va[k] = in ? ks::to_f32(a[base + k]) : 0.f;
        vb[k] = in ? ks::to_f32(b[base + k]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s1[k] += va[k];
      s2[k] = fmaf(va[k], vb[k], s2[k]);
    }
  }
  __shared__ float red[kWarps][2][kTile];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    red[warp][0][lane * 4 + k] = s1[k];
    red[warp][1][lane * 4 + k] = s2[k];
  }
  __syncthreads();
  // 256 threads = 2 sums x 128 columns; warps summed in a fixed order
  const int s = threadIdx.x / kTile;
  const int c = threadIdx.x % kTile;
  float acc = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) acc += red[w][s][c];
  const int col = blockIdx.y * kTile + c;
  if (col < width) partials[(static_cast<int64_t>(blockIdx.x) * 2 + s) * width + col] = acc;
}

// out[s, ch] = sum over blocks and folds of partials[blk, s, f*C + ch]; one
// block per (ch, s), a strided sum per thread then a fixed tree.
__global__ void __launch_bounds__(kThreads)
pair_finalize(const float* __restrict__ partials, float* __restrict__ out, int nblk, int width,
              int c) {
  const int ch = blockIdx.x;
  const int s = blockIdx.y;
  const int fold = width / c;
  const int64_t terms = static_cast<int64_t>(nblk) * fold;
  float acc = 0.f;
  for (int64_t j = threadIdx.x; j < terms; j += kThreads) {
    const int64_t blk = j / fold;
    const int f = static_cast<int>(j % fold);
    acc += partials[(blk * 2 + s) * width + static_cast<int64_t>(f) * c + ch];
  }
  __shared__ float red[kThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[s * c + ch] = red[0];
}

template <typename T>
void launch(const void* a, const void* b, float* partials, float* out, int64_t rows, int width,
            int c, int nblk, int64_t rows_per_block, cudaStream_t stream) {
  const dim3 grid(nblk, (width + kTile - 1) / kTile);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(a) % align == 0 &&
                   reinterpret_cast<uintptr_t>(b) % align == 0;
  if (vec) {
    pair_partials<T, true><<<grid, kThreads, 0, stream>>>(pa, pb, partials, rows, width,
                                                         rows_per_block);
  } else {
    pair_partials<T, false><<<grid, kThreads, 0, stream>>>(pa, pb, partials, rows, width,
                                                          rows_per_block);
  }
  pair_finalize<<<dim3(c, 2), kThreads, 0, stream>>>(partials, out, nblk, width, c);
}

}  // namespace

// a, b: (rows, width) row-major, both f32 (is_bf16 = 0) or both bf16; b may
// alias a. partials: (nblk, 2, width) f32 scratch. out: (2, c) f32.
// width is 128 with c dividing it (fold) or width == c.
extern "C" int ks_pair_sums(const void* a, const void* b, void* partials, void* out,
                            long long rows, int width, int c, int nblk,
                            long long rows_per_block, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  if (is_bf16) {
    launch<__nv_bfloat16>(a, b, p, o, rows, width, c, nblk, rows_per_block, s);
  } else {
    launch<float>(a, b, p, o, rows, width, c, nblk, rows_per_block, s);
  }
  return static_cast<int>(cudaGetLastError());
}
