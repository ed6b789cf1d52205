// Shared helpers of the port's hand-written kernels (plain C interface,
// loaded with ctypes by kurosiwo_torch/kernels/__init__.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ks {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Four consecutive elements as one 16-byte (f32) or 8-byte (bf16) load;
// the caller guarantees the alignment.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// ---- bf16 tensor-core tiles: mma.sync m16n8k16 with f32 accumulators --------
// Shared by the attention kernels (attention_tiles.cuh) and the 3x3 convs.

__device__ __forceinline__ uint32_t pack(float lo, float hi) {  // rounds to nearest even
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b for a 16x16 A (row-major) and a 16x8 B (column-major), f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of a row-major
// tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = t + (r0 + lane / 4) * ld + k0 + (lane % 4) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// The same A fragment with one ldmatrix.x4 (16-byte aligned rows)
__device__ __forceinline__ void load_a_x4(uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                          int r0, int k0) {
  const int lane = threadIdx.x & 31, mat = lane / 8;
  ldmatrix_x4(a, t + (r0 + (mat & 1) * 8 + lane % 8) * ld + k0 + (mat >> 1) * 8);
}

// B fragments (k 16 x n 8) of the two column tiles n0 and n0 + 8 of a
// row-major tile whose ROW is n (k along the row from k0): one ldmatrix.x4.
// b[0], b[1] belong to n0, b[2], b[3] to n0 + 8.
__device__ __forceinline__ void load_b_x4(uint32_t (&b)[4], const __nv_bfloat16* t, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31, mat = lane / 8;
  ldmatrix_x4(b, t + (n0 + (mat >> 1) * 8 + lane % 8) * ld + k0 + (mat & 1) * 8);
}

// B fragments (k 16 x n 8) of the two column tiles n0 and n0 + 8 of a
// row-major tile whose ROW is k (from k0): one ldmatrix.x4.trans. b[0], b[1]
// belong to n0, b[2], b[3] to n0 + 8.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const __nv_bfloat16* t, int ld,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31, mat = lane / 8;
  ldmatrix_x4_trans(b, t + (k0 + (mat & 1) * 8 + lane % 8) * ld + n0 + (mat >> 1) * 8);
}

}  // namespace ks

// Every library exports this so a wrapper can name the error a launch returned.
extern "C" const char* ks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
