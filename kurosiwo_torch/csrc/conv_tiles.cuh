// Tile loaders shared by the 3x3 convolution kernels (conv3x3.cu: B6, B8;
// conv_dw.cu: B7). Activations are NHWC; a "pixel" is one (b, h, w) row of C
// channels. A thread moves 16 bytes at a time: 8 bf16 or 4 f32 channels of
// one pixel. Pixels outside the image and channels past C read as 0, which is
// the SAME convolution's zero padding.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load

// 16 bytes of T at p, of which the first `valid` elements are real (0 when
// valid <= 0); one vector load when all are real and the tensor allows it
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, int valid, bool vec_ok) {
  constexpr int V = kVec<T>;
  if (valid >= V && vec_ok) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < valid) e[j] = p[j];
  return r;
}

// relu(scale * v + bias) in f32 on the `valid` real elements of a loaded
// vector, rounded back to T (the rest stay 0)
template <typename T>
__device__ __forceinline__ uint4 affine_relu(uint4 r, const float* scale, const float* bias,
                                             int valid) {
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) {
    float v = 0.f;
    if (j < valid) v = fmaxf(fmaf(ks::to_f32(e[j]), __ldg(scale + j), __ldg(bias + j)), 0.f);
    e[j] = ks::from_f32<T>(v);
  }
  return r;
}

// One output pixel's position, computed once per thread and load slot.
struct Pixel {
  long long m;  // flat index over B * H * W
  int h, w;
  bool live;    // m < B * H * W
};

__device__ __forceinline__ Pixel make_pixel(long long m, long long count, int h, int w) {
  Pixel p;
  p.m = m;
  p.live = m < count;
  p.w = static_cast<int>(m % w);
  p.h = static_cast<int>((m / w) % h);
  return p;
}

// Move a pixel `step` rows on (step > 0) without a division: the walk of a
// thread's load slot from one K chunk to the next
__device__ __forceinline__ void advance(Pixel& p, int step, long long count, int h, int w) {
  p.m += step;
  p.live = p.m < count;
  p.w += step;
  while (p.w >= w) {
    p.w -= w;
    if (++p.h == h) p.h = 0;
  }
}

// Elements of channels [c, c + V) of the pixel shifted by (dh, dw) that are
// real: 0 outside the image, else min(V, C - c) (may be <= 0)
__device__ __forceinline__ int shifted_valid(const Pixel& p, int dh, int dw, int h, int w,
                                             int c, int channels) {
  const int hh = p.h + dh, ww = p.w + dw;
  const bool in = p.live && hh >= 0 && hh < h && ww >= 0 && ww < w;
  return in ? channels - c : 0;
}

}  // namespace
