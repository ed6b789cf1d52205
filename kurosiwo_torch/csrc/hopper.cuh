// Building blocks of the Hopper (sm_90a) kernels: warpgroup matrix products
// (wgmma) on operands in 128-byte-swizzled shared memory, fed by TMA tile
// copies whose completion is counted on mbarriers. Users: the 3x3
// convolution kernels (conv3x3.cu: B6, conv_dw.cu: B7, conv_fused.cu: B8,
// which also stores its output tiles by TMA) and the bf16 flash
// attention kernels at D 64 and 128 (flash_attention.cu: B5) and short-
// sequence attention kernels (short_attention.cu and long_attention.cu: B4,
// through attention_hw.cuh).
//
// Shared-memory operand layout ("B128 tiles"). A tile is stored in 128-byte
// rows of 64 bf16 values, in atoms of 8 rows (1024 bytes, 1024-byte
// aligned). Inside an atom the 16-byte chunk c of row r lies at chunk
// c ^ r: eight threads writing one column of chunks hit eight different
// banks, and it is the layout TMA writes and wgmma reads with the 128-byte
// swizzle.
//  * K-major (K along the row): rows are M (or N) indices, a row holds 64
//    K values; a warpgroup's m64 tile is 64 consecutive rows (8 KB).
//  * MN-major (M or N along the row): rows are K indices, a row holds 64
//    M (or N) values; a wider tile is several such 64-column blocks, each
//    `rows` x 128 bytes, one after the other.
// For bf16 wgmma reads either layout of A and of B through the descriptor
// and its transpose bits, so an operand goes in as it lies in memory.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace hopper {

// byte offset of 16-byte chunk `c` (0..7) of row `r` in a B128 tile
__device__ __forceinline__ uint32_t b128_offset(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy that wgmma reads and TMA writes through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and TMA tile copies

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA); the
// block's threads then meet at a __syncthreads before first use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies completing on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one arrival, no transaction bytes (release: this thread's earlier shared
// memory writes are visible to a thread whose wait sees the phase complete)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
}

// TMA: the box of `map` at (c0 inner, c1 outer) elements into shared memory
// at dst, completing on bar. Coordinates may lie outside the tensor, even
// below 0: what is outside reads as 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA: the box of a 4-D `map` at (c0 innermost, ..., c3) elements, as
// tma_load_2d; what lies outside the tensor in any dimension reads as 0.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// TMA: the box of a 4-D `map` at (c0 innermost, ..., c3) elements from
// shared memory at src into the tensor; what lies outside the tensor is not
// written. The store joins the thread's open bulk group (bulk_commit).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap& map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// close this thread's bulk group of stores (an empty group when it has none)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read their shared
// memory (the source may then be written again) ...
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ... or are still writing to the tensor
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Host: libcuda's tensor-map encoder (cuTensorMapEncodeTiled), reached
// through the runtime so that nothing links against libcuda; null where the
// installed CUDA does not have it.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000, cudaEnableDefault,
        &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) encode = nullptr;
  }
  return encode;
}

// Host: the tensor map of a row-major bf16 matrix (rows x cols, 16-byte
// aligned rows) read in boxes of box_rows x 64 columns (128 bytes) that land
// as B128 tiles. Returns a CUresult (0: success).
inline int encode_bf16_rows(CUtensorMap* map, const void* base, long long rows, int cols,
                            int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, stride,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Host: the rank-4 tensor map of a (B, H, N, D) bf16 view with unit stride
// in D and element strides sb, sh, sn (16-byte multiples, base 16-byte
// aligned, in any order: the head views of a packed (B, N, 3 H D) projection
// qualify). Dimensions innermost first are (D, N, H, B); a box is box_rows
// rows of one (batch, head) by 64 of D (128 bytes), landing as a B128 tile.
// Rows at or past N read as 0, never as the next head's or batch's rows.
// Returns a CUresult (0: success).
inline int encode_bf16_heads(CUtensorMap* map, const void* base, int b, int h, int n, int d,
                             long long sb, long long sh, long long sn, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(sh) * 2,
                                static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, stride,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Host: the rank-4 tensor map of a contiguous NHWC bf16 tensor (B, H, W, C),
// C % 8 == 0 and the base 16-byte aligned. Dimensions innermost first are
// (C, W, H, B); a box is box_h rows of box_w pixels of one image, all C
// channels, landing as [box_h][box_w][C]. Pixels of C * 2 = 32, 64 or 128
// bytes land with TMA's swizzle of that width: the 16-byte chunk at byte
// offset o moves to chunk bits o[4..] XOR o[7..] (1, 2 or 3 bits;
// swizzled() below), so eight consecutive pixels' chunks of one column fall
// in eight different bank groups. Other C land unswizzled. The box
// lands 1024-byte aligned; a store reads it from shared memory in the same
// layout. Returns a CUresult (0: success).
inline int encode_bf16_nhwc(CUtensorMap* map, const void* base, int b, int h, int w, int c,
                            int box_w, int box_h) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t pixel = static_cast<cuuint64_t>(c) * 2;
  const cuuint64_t stride[3] = {pixel, pixel * w, pixel * w * h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(c), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUtensorMapSwizzle mode = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (pixel == 32) mode = CU_TENSOR_MAP_SWIZZLE_32B;
  if (pixel == 64) mode = CU_TENSOR_MAP_SWIZZLE_64B;
  if (pixel == 128) mode = CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, stride,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, mode, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Host: the XOR mask of that swizzle for rows of `row_bytes` (0:
// unswizzled) ...
inline uint32_t swizzle_mask(int row_bytes) {
  return row_bytes == 32 ? 1 : row_bytes == 64 ? 3 : row_bytes == 128 ? 7 : 0;
}

// ... and where byte `off` of an unswizzled box lies in the swizzled one
// (off from a 1024-byte aligned base)
__device__ __forceinline__ uint32_t swizzled(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// ---- wgmma

// Matrix descriptor of a B128 tile starting at shared address `addr`
// (1024-byte aligned, or advanced inside a row by a K step of a K-major
// tile). lbo: bytes between 64-column blocks of an MN-major tile (unused
// for K-major); sbo: bytes between 8-row atoms (1024 when packed).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma that is still in flight
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments held in registers (the RS form reads them while
// the product is in flight)
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, bf16) B (16 x 128, bf16), both from
// shared memory; scale_d = 0 overwrites d instead. TA / TB = 1: A / B is
// MN-major (transposed). Thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 (+ 8) and, for each n8 block j, columns 8 j + 2 (t % 4)
// (+ 1): d[4 j + 2 h + e] is row + 8 h, column + e, as an mma.sync m16n8 C
// fragment per warp.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), both bf16 from shared memory
// (descriptors a, b); scale_d = 0 overwrites d instead. Fragment layout as
// wgmma_m64n128k16, with n8 blocks j < 8.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 32, f32) += A (64 x 16) B (16 x 32), both bf16 from shared memory;
// fragment layout as wgmma_m64n128k16, with n8 blocks j < 4. Narrow products
// keep an accumulator in 16 registers (short_attention.cu's backward).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 48, f32) += A (64 x 16) B (16 x 48), both bf16 from shared memory;
// fragment layout as wgmma_m64n128k16, with n8 blocks j < 6 (long_attention.cu
// at 33-48 keys).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23},"
      " %24, %25, p, 1, 1, %27, %28;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 16, f32) += A (64 x 16) B (16 x 16), both bf16 from shared memory;
// fragment layout as wgmma_m64n128k16, with n8 blocks j < 2 (a head's last
// keys when they fill only 16 of a 64-key block).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t a, uint64_t b,
                                               int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) += A (64 x 16, bf16, from registers) B (16 x 64, bf16,
// from shared memory); a is the warp's mma.sync m16n8k16 A fragment of rows
// 16 (t / 32) .. + 16 of the warpgroup's 64 (wgmma_m64n128k16's C layout,
// packed, is this layout: accumulator_as_a turns one into the other).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// d (64 x N, f32) += A (64 x 16, bf16, from registers) B (16 x N, bf16, from
// shared memory) for the narrow N 16, 32 and 48 (the small-channel conv's
// Cout); A as wgmma_m64n64k16_rs.
template <int TB>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23},"
      " {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// d (64 x 128, f32) += A (64 x 16, bf16, from registers) B (16 x 128, bf16,
// from shared memory); a is the warp's mma.sync m16n8k16 A fragment of rows
// 16 (t / 32) .. + 16 of the warpgroup's 64 (wgmma_m64n128k16's C layout,
// packed, is this layout: accumulator_as_a turns one into the other).
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// the A fragments (k16 steps kk, 4 registers each) of a warpgroup's f32
// accumulator of N columns, rounded to bf16: step kk holds columns 16 kk to
// 16 kk + 16, so the accumulator of one product feeds the next as its A
template <int N>
__device__ __forceinline__ void accumulator_as_a(uint32_t (&a)[N / 16][4],
                                                 const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = ks::pack(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// ---- warp specialisation

// move registers from a producer warpgroup to the consumers (every warp of
// the warpgroup executes it; the roles' code paths never rejoin)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barrier `id` (1..15; 0 is __syncthreads') of `n` threads: wait, or
// arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- the K loop of an implicit GEMM on a ring of TMA stages

constexpr uint32_t kTileB = 16384;  // B stage: 64 K rows x 128 N, MN-major (two 64-column blocks)

// shared bytes of an NWG-warpgroup ring of S stages (A: NWG x 8 KB), one
// mbarrier each, and 1 KB of alignment slack
template <int NWG, int S>
__host__ __device__ constexpr int ring_bytes() {
  return S * (NWG * 8192 + static_cast<int>(kTileB) + 8) + 1024;
}

// acc (each warpgroup's m64 x n128 tile) += the sum over `chunks` K chunks
// of 64 of A_chunk B_chunk, with the ring of S stages at `smem` (1024-byte
// aligned); the copies run S - 2 chunks ahead.
//  * issue(i, a, b, bar), called by thread 0 for i = 0, 1, 2, ... in order,
//    arms the stage's mbarrier `bar` with the bytes of chunk i
//    (mbar_arrive_expect_tx) and starts the TMA boxes that copy it into the
//    A stage at shared address a and the B stage at b.
//  * fixup(i, a), called by every thread once chunk i has landed, may
//    rewrite the A stage (e.g. zero rows a box should not have read).
// Tiles are B128: A K-major for TA = 0 (NWG x 64 rows of 64 K), MN-major for
// TA = 1 (64 K rows of NWG 64-column blocks); B MN-major. One block-wide
// barrier per chunk: it publishes the chunk that landed and, as every
// warpgroup has retired the product two chunks back, frees that chunk's
// stage for the next copy. At most one wgmma group stays in flight.
template <int NWG, int S, int TA, class Issue, class Fixup>
__device__ __forceinline__ void ring_gemm(float (&acc)[64], uint32_t smem, int chunks,
                                          Issue&& issue, Fixup&& fixup) {
  constexpr uint32_t kTileA = NWG * 8192;
  const uint32_t a0 = smem, b0 = smem + S * kTileA, bars = b0 + S * kTileB;
  const uint32_t wg_a = (threadIdx.x / 128) * 8192;  // the warpgroup's 64 rows or columns of A
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < S - 2 && s < chunks; ++s)
      issue(s, a0 + s * kTileA, b0 + s * kTileB, bars + 8 * s);
  for (int it = 0; it < chunks; ++it) {
    const int st = it % S;
    mbar_wait(bars + 8 * st, (it / S) & 1);  // chunk `it` has landed
    fixup(it, a0 + st * kTileA);
    fence_proxy_async();
    __syncthreads();
    const int next = it + S - 2;
    if (threadIdx.x == 0 && next < chunks)
      issue(next, a0 + (next % S) * kTileA, b0 + (next % S) * kTileB, bars + 8 * (next % S));
    const uint32_t a = a0 + st * kTileA + wg_a, b = b0 + st * kTileB;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // k16 steps: 32 bytes along a K-major row, 16 MN-major rows
      wgmma_m64n128k16<TA, 1>(acc, desc_b128(a + kk * (TA ? 2048 : 32), 8192, 1024),
                              desc_b128(b + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the product of chunk it - 1 has retired
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

}  // namespace hopper
