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
// backward also writes 38.5 MB of dlogits (about 31 us). A pixel costs about
// a hundred instructions (f32 expf and logf at full precision), which at
// this size takes about as long to issue as the bytes take to move, so the
// loads of one unit are kept in flight while the last one is computed.
//
// Design: a streaming pass in 16-byte accesses. A thread takes a unit of
// pixels at a time (the plan, fused_tail.ce_cm_plan, names it):
//   vector NHWC  8 consecutive pixels: 24 logits (three 16-byte loads in
//                bf16, six in f32) and 8 labels (two 16-byte loads);
//   vector PHASE 4 consecutive cells (b, Y, X..X+3) of the phase-space
//                (B,H/2,W/2,12) logits of ops/phase.py, whose logit
//                (b,y,x,c) sits at z[b, y/2, x/2, (2*(y%2) + x%2)*3 + c]:
//                48 logits and the 16 labels of rows 2Y, 2Y+1, columns
//                2X..2X+7 (W % 8 == 0);
//   scalar       one pixel, element loads at any alignment (odd shapes,
//                pointers not 16-byte aligned).
// A thread issues every load of its unit before it uses any, and where two
// units fit in 192 bytes it issues the next unit's loads before it uses
// this one (a software pipeline). Ignore labels are masked by arithmetic
// (weight 0, no cm cell), with no branch before the loads or on the label.
// The backward writes dlogits in the same 16-byte words it read.
//
// The grid is sized to the card: every block one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, read once per kernel) on
// every SM, fewer where the units run out; a block walks a contiguous span of
// units. The pixels past the last whole unit (n mod 8, NHWC) are taken one a
// thread by the last block.
//
// The forward sums num, den (f32) and the 9 live confusion cells (exact
// unsigned counts) per thread, then per block (warp butterfly, the warps in
// order) into the block's partials; each block then draws a ticket, and the
// block that draws the last one folds every block's partials in a fixed
// order (thread t takes blocks t, t + 256, ..., then the block sum) and
// writes loss = num / max(den, 1e-12), max(den, 1e-12) and the cm as f32, and
// sets the ticket back to 0. One launch; no float atomics; the grid depends
// only on the card, the binary and n, so the sums, and the bits, are the
// same run to run. Argmax takes the first maximum, like jnp.argmax and
// torch.argmax.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNHWC = 0;    // layouts, as fused_tail.NHWC and PHASE
constexpr int kPhase = 1;
constexpr int kScalar = 0;  // units, as fused_tail.CE_CM_KERNELS
constexpr int kVector = 1;
constexpr int kParts = 11;  // a block's partials: num, den (f32 bits), 9 cm cells

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ int word(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element i of consecutive 16-byte words of T, as f32
__device__ __forceinline__ float element(const uint4* v, int i, const float*) {
  return __uint_as_float(word(v[i / 4], i % 4));
}
__device__ __forceinline__ float element(const uint4* v, int i, const bf16*) {
  const unsigned u = word(v[i / 8], i % 8 / 2);
  return __uint_as_float(i % 2 ? u & 0xffff0000u : u << 16);
}

// 16-byte word k of g (f32 values in memory order) in T
__device__ __forceinline__ uint4 pack_word(const float* g, int k, const float*) {
  return make_uint4(__float_as_uint(g[4 * k]), __float_as_uint(g[4 * k + 1]),
                    __float_as_uint(g[4 * k + 2]), __float_as_uint(g[4 * k + 3]));
}
__device__ __forceinline__ uint4 pack_word(const float* g, int k, const bf16*) {
  return make_uint4(ks::pack(g[8 * k], g[8 * k + 1]), ks::pack(g[8 * k + 2], g[8 * k + 3]),
                    ks::pack(g[8 * k + 4], g[8 * k + 5]), ks::pack(g[8 * k + 6], g[8 * k + 7]));
}

// A unit: the kPix pixels a thread takes at a time. x(q, c) and label(q) of
// pixel q; slot(q, c) is the place of logit (q, c) among the unit's 3 * kPix
// logits in memory order, where store() writes g[slot].
template <typename T, int L, int K>
struct Unit;

template <typename T, int L>
struct Unit<T, L, kScalar> {
  static constexpr int kPix = 1;
  static constexpr int kBytes = 3 * sizeof(T) + 4;
  static __host__ __device__ int64_t count(int64_t n, int) { return n; }
  static __device__ __forceinline__ int slot(int, int c) { return c; }

  int64_t o;
  float v[3];
  int lab;

  __device__ __forceinline__ void load(const T* x, const int* labels, int64_t u, int h, int w) {
    o = logit_offset<L>(u, h, w);
    lab = labels[u];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = ks::to_f32(x[o + c]);
  }
  __device__ __forceinline__ float x(int, int c) const { return v[c]; }
  __device__ __forceinline__ int label(int) const { return lab; }
  __device__ __forceinline__ void store(T* d, const float* g) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) d[o + c] = ks::from_f32<T>(g[c]);
  }
};

template <typename T, int L>
struct Unit<T, L, kVector> {
  static constexpr int kPix = L == kNHWC ? 8 : 16;
  static constexpr int kRows = kPix / 8;  // label rows of 8
  static constexpr int kWords = 3 * kPix * int(sizeof(T)) / 16;
  static constexpr int kBytes = 16 * (kWords + 2 * kRows);
  // whole units of n pixels (PHASE: the plan requires W % 8 == 0)
  static __host__ __device__ int64_t count(int64_t n, int) { return n / kPix; }
  static __device__ __forceinline__ int slot(int q, int c) {
    if (L == kNHWC) return 3 * q + c;
    const int r = q / 8, col = q % 8;  // label row, column: cell col / 2, phase 2 r + col % 2
    return col / 2 * 12 + (2 * r + col % 2) * 3 + c;
  }

  int64_t o;  // the unit's first logit: consecutive units are consecutive in both layouts
  uint4 v[kWords];
  int4 lab[2 * kRows];

  __device__ __forceinline__ void load(const T* x, const int* labels, int64_t u, int, int w) {
    o = u * 3 * kPix;
    const int* l0 = labels + u * 8;  // NHWC: the unit's labels
    if (L == kPhase) {
      const int64_t per_row = w / 8;  // units of a phase row
      const int64_t t = u / per_row, xq = u - t * per_row;  // phase row b * H/2 + Y, unit in it
      l0 = labels + 2 * t * w + 8 * xq;
    }
    const uint4* px = reinterpret_cast<const uint4*>(x + o);
#pragma unroll
    for (int k = 0; k < kWords; ++k) v[k] = __ldg(px + k);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int4* pl = reinterpret_cast<const int4*>(l0 + r * int64_t(w));
      lab[2 * r] = __ldg(pl);
      lab[2 * r + 1] = __ldg(pl + 1);
    }
  }
  __device__ __forceinline__ float x(int q, int c) const {
    return element(v, slot(q, c), static_cast<const T*>(nullptr));
  }
  __device__ __forceinline__ int label(int q) const { return word(lab[q / 4], q % 4); }
  __device__ __forceinline__ void store(T* d, const float* g) const {
    uint4* pd = reinterpret_cast<uint4*>(d + o);
#pragma unroll
    for (int k = 0; k < kWords; ++k) pd[k] = pack_word(g, k, static_cast<const T*>(nullptr));
  }
};

// the one-hot of a label as 0/1 factors (all 0 for the ignore index);
// dot() picks the labelled value out of three, exactly (the other two
// products are zeros), without a branch
struct OneHot {
  float f0, f1, f2;
  __device__ __forceinline__ explicit OneHot(int lab)
      : f0(lab == 0 ? 1.f : 0.f), f1(lab == 1 ? 1.f : 0.f), f2(lab == 2 ? 1.f : 0.f) {}
  __device__ __forceinline__ float dot(float a, float b, float c) const {
    return fmaf(a, f0, fmaf(b, f1, c * f2));
  }
};

// a thread's sums. The cm cells of the pixels since the last flush() are
// 7-bit counts in one 64-bit word (cell 9, an ignored pixel, lands in bit 63
// and is dropped); flush() adds them to the 32-bit counts. A thread adds at
// most 16 pixels between flushes.
struct Acc {
  float num = 0.f, den = 0.f;
  unsigned cnt[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  unsigned long long cells = 0;

  __device__ __forceinline__ void add(float x0, float x1, float x2, int lab,
                                      const float (&cw)[3]) {
    const float m = fmaxf(x0, fmaxf(x1, x2));
    const float lse = m + logf(expf(x0 - m) + expf(x1 - m) + expf(x2 - m));
    const OneHot hot(lab);
    const float wt = hot.dot(cw[0], cw[1], cw[2]);  // 0 for the ignore index: no weight
    num += wt * (lse - hot.dot(x0, x1, x2));
    den += wt;
    const int pred = x2 > fmaxf(x0, x1) ? 2 : (x1 > x0 ? 1 : 0);
    const int cell = static_cast<unsigned>(lab) < 3u ? lab * 3 + pred : 9;  // 9: no cm row
    cells += 1ull << (7 * cell);
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int k = 0; k < 9; ++k) cnt[k] += static_cast<unsigned>(cells >> (7 * k)) & 127u;
    cells = 0;
  }
};

// the block's sum of every thread's (num, den, cnt) in a fixed order (warp
// butterfly, then the warps in order); thread k < kParts returns part k
// (num and den as f32 bits)
__device__ __forceinline__ unsigned block_sum(float num, float den, const unsigned (&cnt)[9]) {
  unsigned c[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = cnt[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, off);
    den += __shfl_xor_sync(0xffffffffu, den, off);
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] += __shfl_xor_sync(0xffffffffu, c[k], off);
  }
  __shared__ unsigned red[kWarps][kParts];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp][0] = __float_as_uint(num);
    red[warp][1] = __float_as_uint(den);
#pragma unroll
    for (int k = 0; k < 9; ++k) red[warp][2 + k] = c[k];
  }
  __syncthreads();
  unsigned part = 0;
  if (threadIdx.x < 2) {
    float acc = 0.f;
    for (int i = 0; i < kWarps; ++i) acc += __uint_as_float(red[i][threadIdx.x]);
    part = __float_as_uint(acc);
  } else if (threadIdx.x < kParts) {
    for (int i = 0; i < kWarps; ++i) part += red[i][threadIdx.x];
  }
  __syncthreads();  // red is free for the next call
  return part;
}

// [begin, end) of this block's units
struct Span {
  int64_t begin, end;
};

__device__ __forceinline__ Span block_span(int64_t units) {
  const int64_t per = (units + gridDim.x - 1) / gridDim.x;
  const int64_t begin = per * blockIdx.x < units ? per * blockIdx.x : units;
  return {begin, begin + per < units ? begin + per : units};
}

// f(unit) on each unit of this block's span that this thread takes (every
// kThreads-th); where two units fit in 192 bytes, the next unit's loads are
// issued before f uses this one
template <typename U, typename T, typename F>
__device__ __forceinline__ void walk(Span s, const T* x, const int* labels, int h, int w, F&& f) {
  int64_t u = s.begin + threadIdx.x;
  if (2 * U::kBytes > 192) {
    for (; u < s.end; u += kThreads) {
      U unit;
      unit.load(x, labels, u, h, w);
      f(unit);
    }
    return;
  }
  U cur, next;
  if (u < s.end) cur.load(x, labels, u, h, w);
  for (; u < s.end; u += kThreads) {
    const bool more = u + kThreads < s.end;
    if (more) next.load(x, labels, u + kThreads, h, w);
    f(cur);
    if (more) cur = next;
  }
}

// the pixels past the last whole unit (done of n), one a thread of the last block
template <typename T, int L, typename F>
__device__ __forceinline__ void walk_tail(int64_t done, int64_t n, const T* x, const int* labels,
                                          int h, int w, F&& f) {
  const int64_t p = done + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && p < n) {
    Unit<T, L, kScalar> unit;
    unit.load(x, labels, p, h, w);
    f(unit);
  }
}

template <typename U>
__device__ __forceinline__ void accumulate(Acc& acc, const U& unit, const float (&c)[3]) {
#pragma unroll
  for (int q = 0; q < U::kPix; ++q)
    acc.add(unit.x(q, 0), unit.x(q, 1), unit.x(q, 2), unit.label(q), c);
  acc.flush();
}

// ws: word 0 the ticket (0 between launches), then kParts words a block
template <typename T, int L, int K>
__global__ void __launch_bounds__(kThreads)
ce_cm_fwd(const T* __restrict__ x, const int* __restrict__ labels, const float* __restrict__ cw,
          unsigned* __restrict__ ws, float* __restrict__ out, int64_t n, int h, int w) {
  using U = Unit<T, L, K>;
  const float c[3] = {cw[0], cw[1], cw[2]};
  Acc acc;
  const int64_t units = U::count(n, w);
  walk<U>(block_span(units), x, labels, h, w, [&](const U& unit) { accumulate(acc, unit, c); });
  walk_tail<T, L>(units * U::kPix, n, x, labels, h, w,
                  [&](const Unit<T, L, kScalar>& p) { accumulate(acc, p, c); });

  unsigned* ticket = ws;
  unsigned* parts = ws + 1;
  const unsigned part = block_sum(acc.num, acc.den, acc.cnt);
  if (threadIdx.x < kParts) {
    parts[blockIdx.x * kParts + threadIdx.x] = part;
    __threadfence();  // the partials are visible before the ticket is drawn
  }
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: fold every block's partials, in an order fixed by block index
  __threadfence();
  float num = 0.f, den = 0.f;
  unsigned cnt[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const unsigned* p = parts + b * kParts;
    num += __uint_as_float(__ldcg(p));
    den += __uint_as_float(__ldcg(p + 1));
#pragma unroll
    for (int k = 0; k < 9; ++k) cnt[k] += __ldcg(p + 2 + k);
  }
  const unsigned total = block_sum(num, den, cnt);
  __shared__ unsigned sums[kParts];
  if (threadIdx.x < kParts) sums[threadIdx.x] = total;
  __syncthreads();
  // out = [loss, max(den, 1e-12), cm (4x4, row = label, col = pred)]
  if (threadIdx.x < 16) {
    const int row = threadIdx.x / 4, col = threadIdx.x % 4;
    out[2 + threadIdx.x] =
        row < 3 && col < 3 ? static_cast<float>(sums[2 + row * 3 + col]) : 0.f;
  }
  if (threadIdx.x == 0) {
    const float total_w = fmaxf(__uint_as_float(sums[1]), 1e-12f);
    out[0] = __uint_as_float(sums[0]) / total_w;
    out[1] = total_w;
    *ticket = 0;
  }
}

// dlogits of a unit: gs * w * (softmax - onehot), stored in the logits' words
template <typename U, typename T>
__device__ __forceinline__ void write_grad(const U& unit, const float (&cw)[3], float gs, T* d) {
  float g[3 * U::kPix];
#pragma unroll
  for (int q = 0; q < U::kPix; ++q) {
    const float x0 = unit.x(q, 0), x1 = unit.x(q, 1), x2 = unit.x(q, 2);
    const OneHot hot(unit.label(q));
    const float m = fmaxf(x0, fmaxf(x1, x2));
    const float e0 = expf(x0 - m), e1 = expf(x1 - m), e2 = expf(x2 - m);
    const float inv = 1.f / (e0 + e1 + e2);
    const float gw = gs * hot.dot(cw[0], cw[1], cw[2]);
    g[U::slot(q, 0)] = gw * (e0 * inv - hot.f0);
    g[U::slot(q, 1)] = gw * (e1 * inv - hot.f1);
    g[U::slot(q, 2)] = gw * (e2 * inv - hot.f2);
  }
  unit.store(d, g);
}

template <typename T, int L, int K>
__global__ void __launch_bounds__(kThreads)
ce_cm_bwd(const T* __restrict__ x, const int* __restrict__ labels, const float* __restrict__ cw,
          const float* __restrict__ gscale, T* __restrict__ d, int64_t n, int h, int w) {
  using U = Unit<T, L, K>;
  const float c[3] = {cw[0], cw[1], cw[2]};
  const float gs = gscale[0];
  const int64_t units = U::count(n, w);
  walk<U>(block_span(units), x, labels, h, w, [&](const U& unit) { write_grad(unit, c, gs, d); });
  walk_tail<T, L>(units * U::kPix, n, x, labels, h, w,
                  [&](const Unit<T, L, kScalar>& p) { write_grad(p, c, gs, d); });
}

// ---- launches

struct Occupancy {
  cudaError_t err;
  int per_sm;  // blocks one SM holds at once
  int regs;    // registers a thread
};

template <typename F>
Occupancy occupancy_of(F kernel) {
  Occupancy o{cudaSuccess, 0, 0};
  cudaFuncAttributes a;
  o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kernel, kThreads, 0);
  if (o.err == cudaSuccess) o.err = cudaFuncGetAttributes(&a, kernel);
  if (o.err == cudaSuccess) o.regs = a.numRegs;
  if (o.err == cudaSuccess && o.per_sm < 1) o.err = cudaErrorInvalidConfiguration;
  return o;
}

// read once per kernel
template <typename T, int L, int K, bool kFwd>
const Occupancy& occupancy() {
  static const Occupancy o =
      kFwd ? occupancy_of(ce_cm_fwd<T, L, K>) : occupancy_of(ce_cm_bwd<T, L, K>);
  return o;
}

cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

struct Grid {
  int blocks, per_sm, regs;
};

// every block the card holds at once, fewer where the units run out
template <typename T, int L, int K, bool kFwd>
cudaError_t grid_of(int64_t n, int w, Grid* g) {
  const Occupancy& o = occupancy<T, L, K, kFwd>();
  if (o.err != cudaSuccess) return o.err;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t units = Unit<T, L, K>::count(n, w);
  const int64_t want = units > kThreads ? (units + kThreads - 1) / kThreads : 1;
  const int64_t all = static_cast<int64_t>(sms) * o.per_sm;
  g->blocks = static_cast<int>(all < want ? all : want);
  g->per_sm = o.per_sm;
  g->regs = o.regs;
  return cudaSuccess;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// whether a call fits unit `kernel`: the plan's rule (fused_tail.ce_cm_plan)
bool fits(int layout, int kernel, long long n, int h, int w, const void* a, const void* b,
          const void* c) {
  if (n < 1 || h < 1 || w < 1 || (layout != kNHWC && layout != kPhase)) return false;
  if (layout == kPhase && (h % 2 || w % 2)) return false;
  if (kernel == kScalar) return true;
  if (kernel != kVector || !aligned(a) || !aligned(b) || !aligned(c)) return false;
  return layout == kNHWC ? n >= 8 : w % 8 == 0;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(T*, Int<layout>, Int<unit>) of the call's instantiation
template <typename F>
cudaError_t dispatch(int is_bf16, int layout, int kernel, F&& f) {
  auto by_layout = [&](auto t) {
    if (layout == kPhase)
      return kernel == kVector ? f(t, Int<kPhase>(), Int<kVector>())
                               : f(t, Int<kPhase>(), Int<kScalar>());
    return kernel == kVector ? f(t, Int<kNHWC>(), Int<kVector>())
                             : f(t, Int<kNHWC>(), Int<kScalar>());
  };
  return is_bf16 ? by_layout(static_cast<bf16*>(nullptr)) : by_layout(static_cast<float*>(nullptr));
}

}  // namespace

// The grid of a launch: blocks, blocks an SM, registers a thread; fwd 1 for
// the forward, 0 for the backward.
extern "C" int ks_ce_cm_grid(int fwd, int layout, int is_bf16, int kernel, long long n, int h,
                             int w, int* blocks, int* per_sm, int* regs) {
  if (!fits(layout, kernel, n, h, w, nullptr, nullptr, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g{0, 0, 0};
  const cudaError_t err = dispatch(is_bf16, layout, kernel, [&](auto t, auto l, auto k) {
    using T = std::remove_pointer_t<decltype(t)>;
    return fwd ? grid_of<T, decltype(l)::value, decltype(k)::value, true>(n, w, &g)
               : grid_of<T, decltype(l)::value, decltype(k)::value, false>(n, w, &g);
  });
  *blocks = g.blocks;
  *per_sm = g.per_sm;
  *regs = g.regs;
  return static_cast<int>(err);
}

// logits: contiguous, f32 or bf16 (is_bf16), NHWC (B,H,W,3) for layout 0 or
// phase (B,H/2,W/2,12) for layout 1; labels: (B,H,W) int32; cw: (3,) f32;
// ws: int32 workspace of the stream, word 0 the ticket (0 between launches)
// and 11 words for each of ws_blocks blocks; out: (18,) f32; kernel: the
// plan's unit (0 scalar, 1 vector). Refuses (cudaErrorInvalidValue) a unit
// that does not fit the call and a workspace smaller than the grid.
extern "C" int ks_ce_cm_fwd(const void* logits, const void* labels, const void* cw, void* ws,
                            int ws_blocks, void* out, long long n, int h, int w, int layout,
                            int is_bf16, int kernel, void* stream) {
  if (!fits(layout, kernel, n, h, w, logits, labels, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(is_bf16, layout, kernel, [&](auto t, auto l, auto k) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int L = decltype(l)::value, K = decltype(k)::value;
    Grid g;
    const cudaError_t err = grid_of<T, L, K, true>(n, w, &g);
    if (err != cudaSuccess) return err;
    if (g.blocks > ws_blocks) return cudaErrorInvalidValue;
    ce_cm_fwd<T, L, K><<<g.blocks, kThreads, 0, s>>>(
        static_cast<const T*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(cw), static_cast<unsigned*>(ws), static_cast<float*>(out), n, h,
        w);
    return cudaGetLastError();
  }));
}

// gscale: (1,) f32 on the device, g / max(sum(w), 1e-12); d: like logits.
extern "C" int ks_ce_cm_bwd(const void* logits, const void* labels, const void* cw,
                            const void* gscale, void* d, long long n, int h, int w, int layout,
                            int is_bf16, int kernel, void* stream) {
  if (!fits(layout, kernel, n, h, w, logits, labels, d))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(is_bf16, layout, kernel, [&](auto t, auto l, auto k) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int L = decltype(l)::value, K = decltype(k)::value;
    Grid g;
    const cudaError_t err = grid_of<T, L, K, false>(n, w, &g);
    if (err != cudaSuccess) return err;
    ce_cm_bwd<T, L, K><<<g.blocks, kThreads, 0, s>>>(
        static_cast<const T*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(cw), static_cast<const float*>(gscale), static_cast<T*>(d), n,
        h, w);
    return cudaGetLastError();
  }));
}
