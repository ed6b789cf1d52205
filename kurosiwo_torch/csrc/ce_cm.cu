// Class-weighted cross entropy (ignore index 3, torch's weight-sum
// denominator) and the 4x4 confusion matrix of the argmax, in one pass over
// 3-class logits; and the matching backward, dlogits = g/sum(w) * w *
// (softmax - onehot).
//
// Replaces the TPU kernels of kurosiwo_tpu/ops/pallas_tail.py:
//   NHWC  instantiation: _fwd_kernel (via _run_fwd) and _bwd_kernel (via _run_bwd)
//   PHASE instantiation: _phase_fwd_kernel (via _phase_run_fwd) and
//                        _phase_bwd_kernel (via _phase_fused_bwd)
//
// Bound on an H100 (3.35 TB/s): bytes. At batch 128, 224x224 the forward
// reads 38.5 MB of bf16 logits and 25.7 MB of int32 labels (about 19 us); the
// backward also writes 38.5 MB of dlogits (about 31 us). A pixel costs a few
// dozen operations, far below the card's ~300 operations per byte.
//
// Design: one thread per pixel in a grid-stride loop. Each kernel is
// templated on the logits' index map, so the same code reads (B,H,W,3)
// logits and the phase-space (B,H/2,W/2,12) logits of ops/phase.py, whose
// logit (b,y,x,c) sits at z[b, y/2, x/2, (2*(y%2) + x%2)*3 + c]. The forward
// reduces num, den (f32) and the 9 live confusion cells (exact unsigned
// counts) to per-block partials through warp shuffles and shared memory in a
// fixed order; a second one-block launch sums the partials in a fixed order
// and writes loss = num / max(den, 1e-12), max(den, 1e-12) and the cm as f32.
// No atomics, so the result is deterministic. Argmax takes the first
// maximum, like jnp.argmax and torch.argmax.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNHWC = 0;
constexpr int kPhase = 1;

// offset of logit (pixel p, class 0); p enumerates the (B, H, W) labels
template <int L>
__device__ __forceinline__ int64_t logit_offset(int64_t p, int h, int w) {
  if (L == kNHWC) return p * 3;
  const int64_t x = p % w;
  const int64_t t = p / w;
  const int64_t y = t % h;
  const int64_t b = t / h;
  return ((b * (h / 2) + y / 2) * (w / 2) + x / 2) * 12 + (2 * (y & 1) + (x & 1)) * 3;
}

__device__ __forceinline__ float class_weight(int lab, float c0, float c1, float c2) {
  return lab == 0 ? c0 : (lab == 1 ? c1 : (lab == 2 ? c2 : 0.f));
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
ce_cm_partials(const T* __restrict__ logits, const int* __restrict__ labels,
               const float* __restrict__ cw, float* __restrict__ part_f,
               unsigned* __restrict__ part_i, int64_t n, int h, int w) {
  const float c0 = cw[0], c1 = cw[1], c2 = cw[2];
  float num = 0.f, den = 0.f;
  unsigned cnt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) cnt[k] = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < n; p += stride) {
    const int lab = labels[p];
    if (lab < 0 || lab > 2) continue;  // ignore index 3: no weight, no cm row
    const int64_t o = logit_offset<L>(p, h, w);
    const float x0 = ks::to_f32(logits[o]);
    const float x1 = ks::to_f32(logits[o + 1]);
    const float x2 = ks::to_f32(logits[o + 2]);
    const float m = fmaxf(x0, fmaxf(x1, x2));
    const float lse = m + logf(expf(x0 - m) + expf(x1 - m) + expf(x2 - m));
    const float picked = lab == 0 ? x0 : (lab == 1 ? x1 : x2);
    const float wt = class_weight(lab, c0, c1, c2);
    num += wt * (lse - picked);
    den += wt;
    const int pred = x2 > fmaxf(x0, x1) ? 2 : (x1 > x0 ? 1 : 0);
    const int cell = lab * 3 + pred;
#pragma unroll
    for (int k = 0; k < 9; ++k) cnt[k] += cell == k;
  }
  // warp butterfly, then warps in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, off);
    den += __shfl_xor_sync(0xffffffffu, den, off);
#pragma unroll
    for (int k = 0; k < 9; ++k) cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], off);
  }
  __shared__ float red_f[kWarps][2];
  __shared__ unsigned red_i[kWarps][9];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red_f[warp][0] = num;
    red_f[warp][1] = den;
#pragma unroll
    for (int k = 0; k < 9; ++k) red_i[warp][k] = cnt[k];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float acc = 0.f;
    for (int i = 0; i < kWarps; ++i) acc += red_f[i][threadIdx.x];
    part_f[blockIdx.x * 2 + threadIdx.x] = acc;
  } else if (threadIdx.x < 11) {
    const int k = threadIdx.x - 2;
    unsigned acc = 0;
    for (int i = 0; i < kWarps; ++i) acc += red_i[i][k];
    part_i[blockIdx.x * 9 + k] = acc;
  }
}

// one block: out = [loss, max(den, 1e-12), cm (4x4, row = label, col = pred)]
__global__ void __launch_bounds__(kThreads)
ce_cm_finalize(const float* __restrict__ part_f, const unsigned* __restrict__ part_i,
               float* __restrict__ out, int nblk) {
  float f[2] = {0.f, 0.f};
  unsigned c[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = 0;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    f[0] += part_f[i * 2];
    f[1] += part_f[i * 2 + 1];
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] += part_i[i * 9 + k];
  }
  __shared__ float rf[2][kThreads];
  __shared__ unsigned ri[9][kThreads];
  rf[0][threadIdx.x] = f[0];
  rf[1][threadIdx.x] = f[1];
#pragma unroll
  for (int k = 0; k < 9; ++k) ri[k][threadIdx.x] = c[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      rf[0][threadIdx.x] += rf[0][threadIdx.x + stride];
      rf[1][threadIdx.x] += rf[1][threadIdx.x + stride];
#pragma unroll
      for (int k = 0; k < 9; ++k) ri[k][threadIdx.x] += ri[k][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x < 16) {
    const int row = threadIdx.x / 4, col = threadIdx.x % 4;
    out[2 + threadIdx.x] =
        (row < 3 && col < 3) ? static_cast<float>(ri[row * 3 + col][0]) : 0.f;
  }
  if (threadIdx.x == 0) {
    const float total_w = fmaxf(rf[1][0], 1e-12f);
    out[0] = rf[0][0] / total_w;
    out[1] = total_w;
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
ce_bwd(const T* __restrict__ logits, const int* __restrict__ labels, const float* __restrict__ cw,
       const float* __restrict__ gscale, T* __restrict__ d, int64_t n, int h, int w) {
  const float c0 = cw[0], c1 = cw[1], c2 = cw[2];
  const float gs = gscale[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < n; p += stride) {
    const int lab = labels[p];
    const int64_t o = logit_offset<L>(p, h, w);
    const float x0 = ks::to_f32(logits[o]);
    const float x1 = ks::to_f32(logits[o + 1]);
    const float x2 = ks::to_f32(logits[o + 2]);
    const float m = fmaxf(x0, fmaxf(x1, x2));
    const float e0 = expf(x0 - m), e1 = expf(x1 - m), e2 = expf(x2 - m);
    const float s = e0 + e1 + e2;
    const float gw = gs * class_weight(lab, c0, c1, c2);
    d[o] = ks::from_f32<T>(gw * (e0 / s - (lab == 0 ? 1.f : 0.f)));
    d[o + 1] = ks::from_f32<T>(gw * (e1 / s - (lab == 1 ? 1.f : 0.f)));
    d[o + 2] = ks::from_f32<T>(gw * (e2 / s - (lab == 2 ? 1.f : 0.f)));
  }
}

template <typename T, int L>
void launch_fwd(const void* logits, const int* labels, const float* cw, float* part_f,
                unsigned* part_i, float* out, int64_t n, int h, int w, int nblk, cudaStream_t s) {
  ce_cm_partials<T, L><<<nblk, kThreads, 0, s>>>(static_cast<const T*>(logits), labels, cw, part_f,
                                                 part_i, n, h, w);
  ce_cm_finalize<<<1, kThreads, 0, s>>>(part_f, part_i, out, nblk);
}

template <typename T, int L>
void launch_bwd(const void* logits, const int* labels, const float* cw, const float* gscale,
                void* d, int64_t n, int h, int w, int nblk, cudaStream_t s) {
  ce_bwd<T, L><<<nblk, kThreads, 0, s>>>(static_cast<const T*>(logits), labels, cw, gscale,
                                         static_cast<T*>(d), n, h, w);
}

}  // namespace

// logits: contiguous, f32 or bf16 (is_bf16), NHWC (B,H,W,3) for layout 0 or
// phase (B,H/2,W/2,12) for layout 1; labels: (B,H,W) int32; cw: (3,) f32;
// part_f: (nblk, 2) f32 and part_i: (nblk, 9) u32 scratch; out: (18,) f32.
extern "C" int ks_ce_cm_fwd(const void* logits, const void* labels, const void* cw, void* part_f,
                            void* part_i, void* out, long long n, int h, int w, int layout,
                            int is_bf16, int nblk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto c = static_cast<const float*>(cw);
  auto pf = static_cast<float*>(part_f);
  auto pi = static_cast<unsigned*>(part_i);
  auto o = static_cast<float*>(out);
  if (is_bf16) {
    if (layout == kPhase) launch_fwd<__nv_bfloat16, kPhase>(logits, lab, c, pf, pi, o, n, h, w, nblk, s);
    else launch_fwd<__nv_bfloat16, kNHWC>(logits, lab, c, pf, pi, o, n, h, w, nblk, s);
  } else {
    if (layout == kPhase) launch_fwd<float, kPhase>(logits, lab, c, pf, pi, o, n, h, w, nblk, s);
    else launch_fwd<float, kNHWC>(logits, lab, c, pf, pi, o, n, h, w, nblk, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// gscale: (1,) f32 on the device, g / max(sum(w), 1e-12); d: like logits.
extern "C" int ks_ce_cm_bwd(const void* logits, const void* labels, const void* cw,
                            const void* gscale, void* d, long long n, int h, int w, int layout,
                            int is_bf16, int nblk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto c = static_cast<const float*>(cw);
  auto g = static_cast<const float*>(gscale);
  if (is_bf16) {
    if (layout == kPhase) launch_bwd<__nv_bfloat16, kPhase>(logits, lab, c, g, d, n, h, w, nblk, s);
    else launch_bwd<__nv_bfloat16, kNHWC>(logits, lab, c, g, d, n, h, w, nblk, s);
  } else {
    if (layout == kPhase) launch_bwd<float, kPhase>(logits, lab, c, g, d, n, h, w, nblk, s);
    else launch_bwd<float, kNHWC>(logits, lab, c, g, d, n, h, w, nblk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
