// The Hopper building blocks of the bf16 attention kernels of B4 on the
// packed (B, N, H*D) layout: short_attention.cu (hw::short_fwd and
// hw::short_bwd, a (batch, head) held whole) and long_attention.cu
// (hw::long_fwd and hw::long_bwd, long queries over at most 64 keys). Tiles
// of 64 rows in B128 layout, read through rank-4 TMA maps over the (B, H, N,
// D) views, wgmma products (hopper.cuh), and the host helpers that build
// the maps and size persistent grids. Each .cu that includes this header is
// its own library, so its helpers sit in the including file's anonymous
// namespace, as attention_tiles.cuh's.
#pragma once

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

template <typename T>
struct View {  // element (b, n, col) at p[b * sb + n * sn + col]
  T* p;
  long long sb, sn;
};

namespace hw {

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

constexpr int kRows = 64;                // rows of every tile: one wgmma m64 of queries or keys
constexpr uint32_t kSmemLimit = 232448;  // dynamic shared memory one block may take (227 KB)
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;

// A [64][D] bf16 tile is D / 64 column blocks of 64 rows x 128 bytes (B128
// tiles, 1024-byte aligned): what one box per column block of a heads map
// writes.
__host__ __device__ constexpr uint32_t tile_bytes(int d) { return kRows * d * 2; }

__device__ __forceinline__ float ex2(float x) {  // 2^x, one SFU op; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// rows row .. row + 64 of one (batch, head) into the tile at dst
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, int row, int h,
                                          int b, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * kRows * 128, map, 64 * c, row, h, b, bar);
}

// x, as a value the compiler cannot compute ahead (where Fresh): a chain's
// descriptors are then formed just before each product, not all at its
// start (two registers each). The backward's warpgroups that hold two key
// tiles' dK and dV (128 registers) need those registers.
template <bool Fresh>
__device__ __forceinline__ uint32_t fresh(uint32_t x) {
  if constexpr (Fresh) asm volatile("" : "+r"(x));
  return x;
}

// shared-memory loads and stores by 32-bit address
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// K-major operand (a tile's rows along M or N, D along the row): k16 step kk
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc_b128(tile + (kk / 4) * kRows * 128 + (kk % 4) * 32, kRows * 128, 1024);
}

// MN-major operand (a tile's rows along K): k16 step kk < 4 of the tile
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_b128(tile + kk * 2048, kRows * 128, 1024);
}

// acc (64 x N) += A B, both from shared memory, for N 16 / 32 / 48 / 64 / 128
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&acc)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 16)
    hopper::wgmma_m64n16k16<TA, TB>(acc, a, b, scale_d);
  else if constexpr (N == 32)
    hopper::wgmma_m64n32k16<TA, TB>(acc, a, b, scale_d);
  else if constexpr (N == 48)
    hopper::wgmma_m64n48k16<TA, TB>(acc, a, b, scale_d);
  else if constexpr (N == 64)
    hopper::wgmma_m64n64k16<TA, TB>(acc, a, b, scale_d);
  else
    hopper::wgmma_m64n128k16<TA, TB>(acc, a, b, scale_d);
}

// acc (64 x N) += A (registers) B (MN-major, shared memory), for N 64 / 128
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64)
    hopper::wgmma_m64n64k16_rs<1>(acc, a, b, scale_d);
  else
    hopper::wgmma_m64n128k16_rs<1>(acc, a, b, scale_d);
}

// this thread's rows of a warpgroup's 64 x D accumulator (rows r and r + 8,
// r = row0 + 16 * warp + lane / 4) into bf16 rows with row stride sn; rows at
// or past n are not written
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, long long sn, int row0, int n,
                                          const float (&acc)[D / 2]) {
  const int lane = threadIdx.x & 31, r = row0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= n) continue;
    bf16* out = dst + (r + 8 * h) * sn + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// sum over 8 bf16 pairs of x * y, in f32, in index order
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

}  // namespace hw

// ---- host

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

int tiles_of(int n) { return (n + hw::kRows - 1) / hw::kRows; }

// the rank-4 tensor map of operand i of the packed layout (batch stride
// st[2 i], head stride d, row stride st[2 i + 1]), n rows, in 64-row boxes
bool heads_map(CUtensorMap* map, void* const* ptr, const long long* st, int i, const Shape& s,
               int n, int d) {
  return hopper::encode_bf16_heads(map, ptr[i], s.batch, s.heads, n, d, st[2 * i], d,
                                   st[2 * i + 1], hw::kRows) == 0;
}

// blocks of `kernel` one SM holds at once (0: none)
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

// the grid of a persistent launch: every block resident at once, none idle
template <typename K>
int resident_grid(K kernel, int threads, size_t smem, int items) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return items;
  const int grid = blocks_per_sm(kernel, threads, smem) * sms;
  return grid > 0 && grid < items ? grid : items;
}

}  // namespace
