// B8 in bf16: y = [relu](conv3x3_SAME(x, w) + b) on NHWC x (B, H, W, Cin)
// with small channel counts, the bias added to the f32 sum and the result
// rounded to bf16. Replaces the TPU kernel
// kurosiwo_tpu/ops/pallas_conv.py::_conv_kernel (:40; conv3x3_fused
// launches it at :85). f32 calls and bf16 calls this kernel does not take
// run conv3x3.cu's simt_conv3x3 and tc_conv3x3 (ks_conv3x3_bias_act); the
// wrapper's plan (ops/conv_fused.py: conv3x3_fused_plan) picks one.
//
// Bound on an H100: at Cin = Cout = 16 on 224^2 and 32 on 112^2 (batch 128)
// a call reads x once and writes y once, 411 and 206 MB, against 29.6 GFLOP
// (K = 9 Cin is 144 or 288): bytes (3.35 TB/s), 123 and 61 us; the product
// takes 30 us at the tensor cores' 989 TFLOP/s, so at 112^2 it must run at
// half of that rate or it sets the pace.
//
// Design ("slab" kernel): a work item is a band of R output rows of one
// image. Resident blocks walk the items in order (block g takes g, g +
// grid, ...), so neighbouring blocks hold neighbouring bands and the halo
// rows two bands read are L2 hits. Per band:
//  * One TMA box of (Cin, W + 2, R + 2, 1) at (0, -1, r0 - 1, b) copies the
//    band's halo slab into shared memory. TMA reads what lies outside the
//    image as 0, so the SAME padding costs nothing: no host pad, no edge
//    mask (the TPU kernel padded the width to a multiple of 8 on the host).
//    Two slabs are in flight: one producer thread copies band k + 2 while
//    the consumers compute band k.
//  * The (9 Cin, Cout) weights sit in shared memory for the whole launch,
//    as K-major B128 tiles (Cout rows of 64 K values), the bias in
//    registers.
//  * Four consumer warpgroups (two at Cout 48 and 64) split the band's R W
//    output pixels, a flat M in m64 tiles that may cross output rows (each
//    half band of R / 2 rows tiled on its own); a warpgroup's tiles run one
//    after another, and the warpgroups hide one another's latencies. For
//    each tap and 16 input channels (the loops unrolled: the kernel is
//    instantiated for each Cout and Cin / 16), ldmatrix reads a warp's A
//    fragment straight from the slab, one address per pixel row, so a tap's
//    shift by one pixel is only an address, and wgmma (the RS form: A from
//    registers, B the resident weights through a descriptor, m64nCoutk16)
//    adds it to f32 accumulators. Pixel rows of 32, 64 or 128 bytes land
//    with TMA's swizzle of that width, and ldmatrix applies the same XOR, so
//    its eight rows hit eight bank groups.
//  * Epilogue: bias in f32, ReLU, round to bf16 into an output tile in
//    shared memory; each half band is stored by one TMA box (Cout, W, R/2,
//    1), which clips the rows past H of an image's last band. A half's
//    buffer is written again only once its previous store has read it.
// Synchronisation is by mbarriers only: full / empty per slab, and per half
// band "written" (every consumer thread, after fence.proxy.async) and
// "free" (the producer, after bulk_wait_read). No value crosses blocks and
// every sum runs in one fixed order, so the output is bitwise repeatable.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSlabs = 2;                      // slabs in flight
constexpr int kBars = 8;                       // full[2], empty[2], written[2], free[2]
constexpr int kSmemLimit = 232448;             // dynamic shared memory of one block (227 KB)

__host__ __device__ inline uint32_t round_1k(uint32_t v) { return (v + 1023) & ~1023u; }

// The shared memory of one block, in bytes from its 1024-byte aligned base:
// the slabs, the two half-band output tiles, the weights, the mbarriers
// (ops/conv_fused.py: slab_smem mirrors it)
struct Layout {
  uint32_t slab, half, weights, bars, bytes;
};

__host__ __device__ inline Layout layout_of(int w, int cin, int cout, int rows) {
  Layout l;
  l.slab = round_1k(static_cast<uint32_t>((rows + 2) * (w + 2) * cin * 2));
  l.half = round_1k(static_cast<uint32_t>(rows / 2 * w * cout * 2));
  l.weights = static_cast<uint32_t>((9 * cin + 63) / 64 * cout * 128);
  l.bars = kSlabs * l.slab + 2 * l.half + l.weights;
  l.bytes = l.bars + 8 * kBars + 1024;  // and 1 KB of alignment slack
  return l;
}

// Consumer warpgroups of a block: four where their registers fit (17 warps
// put 5 on one of the SM's four 16K-register files: at most 102 registers a
// thread; Cout 16 and 32 take 70-95), two for Cout 48 and 64 (up to 125;
// three would cap them at 128 and spill); one more warp is the producer.
template <int N>
__host__ __device__ constexpr int consumer_groups() {
  return N <= 32 ? 4 : 2;
}

template <int N>
__host__ __device__ constexpr int threads_of() {
  return 128 * consumer_groups<N>() + 32;
}

struct Slab {
  const bf16* w;       // (9 Cin, Cout) row-major
  const float* bias;   // (Cout,) f32
  int h, w_, rows, bands, items, relu;
  uint64_t winv;       // ceil(2^32 / W): p / W is (p winv) >> 32 for p < 2^16
  uint32_t swx, swy;   // XOR masks of the slab's and the output tile's swizzle
  Layout l;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc (64 x N) += A (registers) B (K-major weights) for N = Cout
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) hopper::wgmma_m64n16k16_rs<0>(acc, a, b);
  if constexpr (N == 32) hopper::wgmma_m64n32k16_rs<0>(acc, a, b);
  if constexpr (N == 48) hopper::wgmma_m64n48k16_rs<0>(acc, a, b);
  if constexpr (N == 64) hopper::wgmma_m64n64k16_rs<0>(acc, a, b);
}

// N = Cout, C16 = Cin / 16
template <int N, int C16>
__global__ void __launch_bounds__(threads_of<N>(), 1)
slab_conv3x3(const Slab s, const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap ymap) {
  constexpr int kNWG = consumer_groups<N>(), kConsumers = 128 * kNWG, kThreads = kConsumers + 32;
  constexpr int kCin = 16 * C16;
  constexpr uint32_t pix = kCin * 2;  // bytes of a pixel row of x
  extern __shared__ __align__(1024) uint8_t dyn[];
  const uint32_t raw = hopper::smem_addr(dyn), base = (raw + 1023) & ~1023u;
  const uint32_t slab0 = base, out0 = base + kSlabs * s.l.slab, wsm = out0 + 2 * s.l.half;
  const uint32_t full = base + s.l.bars, empty = full + 8 * kSlabs, written = empty + 8 * kSlabs,
                 freed = written + 16;
  const int tid = threadIdx.x;

  if (tid == kConsumers) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(full + 8 * i, 1);
      hopper::mbar_init(empty + 8 * i, kConsumers);
      hopper::mbar_init(written + 8 * i, kConsumers);
      hopper::mbar_init(freed + 8 * i, 1);
    }
    hopper::mbar_init_fence();
  }
  // weights: K row k of tap-major (9 Cin, N) in 64-row chunks, each chunk N
  // K-major rows of 128 bytes (row n holds chunk c's 64 K values of column n)
  const uint16_t* wg16 = reinterpret_cast<const uint16_t*>(s.w);
  for (int i = tid; i < 9 * kCin / 8 * N; i += kThreads) {
    const int n = i % N, k8 = i / N;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = static_cast<uint32_t>(wg16[(k8 * 8 + 2 * q) * N + n]) |
             (static_cast<uint32_t>(wg16[(k8 * 8 + 2 * q + 1) * N + n]) << 16);
    const uint32_t dst = wsm + (k8 / 8) * (N * 128) + hopper::b128_offset(n, k8 % 8);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[0]), "r"(v[1]),
                 "r"(v[2]), "r"(v[3])
                 : "memory");
  }
  hopper::fence_proxy_async();
  __syncthreads();

  const int half_rows = s.rows / 2;
  if (tid >= kConsumers) {
    // ---- producer: slab copies ahead, output stores behind
    if (tid != kConsumers) return;
    const uint32_t slab_tx = static_cast<uint32_t>((s.rows + 2) * (s.w_ + 2)) * pix;
    auto load = [&](int k, int item) {
      const int st = k % kSlabs;
      hopper::mbar_arrive_expect_tx(full + 8 * st, slab_tx);
      hopper::tma_load_4d(slab0 + st * s.l.slab, xmap, 0, -1, (item % s.bands) * s.rows - 1,
                          item / s.bands, full + 8 * st);
    };
    for (int k = 0; k < kSlabs && static_cast<int>(blockIdx.x + k * gridDim.x) < s.items; ++k)
      load(k, static_cast<int>(blockIdx.x + k * gridDim.x));
    hopper::mbar_arrive(freed);
    hopper::mbar_arrive(freed + 8);
    int k = 0;
    for (int item = blockIdx.x; item < s.items; item += gridDim.x, ++k) {
      const int b = item / s.bands, r0 = (item % s.bands) * s.rows;
      for (int hf = 0; hf < 2; ++hf) {
        hopper::mbar_wait(written + 8 * hf, k & 1);
        if (r0 + hf * half_rows < s.h)  // rows past H are clipped; a box wholly past it skipped
          hopper::tma_store_4d(ymap, out0 + hf * s.l.half, 0, 0, r0 + hf * half_rows, b);
        hopper::bulk_commit();
      }
      const int next = item + kSlabs * static_cast<int>(gridDim.x);
      if (next < s.items) {
        hopper::mbar_wait(empty + 8 * (k % kSlabs), (k / kSlabs) & 1);
        load(k + kSlabs, next);
      }
      hopper::bulk_wait_read<1>();  // the first half's store has read its tile
      hopper::mbar_arrive(freed);
      hopper::bulk_wait_read<0>();
      hopper::mbar_arrive(freed + 8);
    }
    hopper::bulk_wait<0>();
    return;
  }

  // ---- consumers
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int half_px = half_rows * s.w_, tiles = (half_px + 63) / 64;
  const uint32_t row = (s.w_ + 2) * pix;
  // the descriptor of the resident weights; a k16 step adds its offset
  const uint64_t wdesc = hopper::desc_b128(wsm, N * 128, 1024);
  // this lane's ldmatrix row of a tile, and its 8-channel half of a k16 step
  const int lrow = warp * 16 + (lane & 15);
  const uint32_t khalf = (lane >> 4) * 16;
  // the epilogue's columns 8 j + 2 (lane % 4) (+1) of the wgmma C fragment
  float bias[N / 8][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bias[j][0] = __ldg(s.bias + 8 * j + 2 * (lane % 4));
    bias[j][1] = __ldg(s.bias + 8 * j + 2 * (lane % 4) + 1);
  }
  int k = 0;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x, ++k) {
    const uint32_t slab = slab0 + (k % kSlabs) * s.l.slab;
    hopper::mbar_wait(full + 8 * (k % kSlabs), (k / kSlabs) & 1);
    int hf_open = 0;        // the half band this thread has not yet reported written
    bool writable = false;  // whether that half's previous store has read its tile
    for (int g = wg;; g += kNWG) {
      const int hf = g < tiles ? 0 : g < 2 * tiles ? 1 : 2;
      for (; hf_open < hf; ++hf_open) {
        // every thread waits for the free phase before it reports written,
        // so no report of this band can count toward the last band's phase
        if (!writable) hopper::mbar_wait(freed + 8 * hf_open, k & 1);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(written + 8 * hf_open);
        writable = false;
      }
      if (hf == 2) break;
      const int tile = g - hf * tiles;
      // the lane's pixel (past the half's end: its last, read and dropped)
      const int p = min(tile * 64 + lrow, half_px - 1) + hf * half_px;
      const int r = static_cast<int>((static_cast<uint64_t>(p) * s.winv) >> 32);
      const uint32_t a0 = r * row + (p - r * s.w_) * pix + khalf;
      const uint32_t arow[3] = {a0, a0 + row, a0 + 2 * row};
      // at Cout 48 and 64 the 9 Cin / 16 descriptors, hoisted out of the
      // tile loop, would spill: derive them in the tile instead
      uint64_t wd = wdesc;
      if constexpr (N >= 48) asm volatile("" : "+l"(wd));
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int c16 = 0; c16 < C16; ++c16) {
        uint32_t a[9][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          ldmatrix_x4(a[tap], slab + hopper::swizzled(arow[tap / 3] + (tap % 3) * pix + c16 * 32,
                                                      s.swx));
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int k0 = tap * kCin + 16 * c16;  // the K rows of this step
          wgmma_rs<N>(acc, a[tap], wd + (((k0 / 64) * (N * 128) + (k0 / 16 % 4) * 32) >> 4));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(a);
      }
      if (!writable) {
        hopper::mbar_wait(freed + 8 * hf, k & 1);
        writable = true;
      }
      const uint32_t out = out0 + hf * s.l.half;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int pe = tile * 64 + warp * 16 + lane / 4 + 8 * h8;
        if (pe >= half_px) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float v0 = acc[4 * j + 2 * h8] + bias[j][0], v1 = acc[4 * j + 2 * h8 + 1] + bias[j][1];
          if (s.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const uint32_t off = hopper::swizzled(pe * (N * 2) + (8 * j + 2 * (lane % 4)) * 2, s.swy);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(out + off), "r"(ks::pack(v0, v1))
                       : "memory");
        }
      }
    }
    // the slab's last reads (ldmatrix) are done: hand it back for the next copy
    hopper::fence_proxy_async();
    hopper::mbar_arrive(empty + 8 * (k % kSlabs));
  }
}

// whether the slab kernel takes a call (the layout's own limits; the
// wrapper's plan asks the same, ops/conv_fused.py: slab_takes)
bool takes(const void* x, const void* y, int h, int w, int cin, int cout, int rows) {
  return cin % 16 == 0 && cin >= 16 && cin <= 64 && cout % 16 == 0 && cout >= 16 && cout <= 64 &&
         h >= 1 && w >= 1 && w + 2 <= 256 && rows >= 2 && rows % 2 == 0 && rows + 2 <= 256 &&
         layout_of(w, cin, cout, rows).bytes <= static_cast<uint32_t>(kSmemLimit) &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

// One instantiation of the kernel, its dynamic shared memory limit raised
// once
struct Instance {
  const void* fn;
  int threads;
  cudaError_t attr;
};

template <int N, int C16>
const Instance& instance() {
  static const Instance i{
      reinterpret_cast<const void*>(slab_conv3x3<N, C16>), threads_of<N>(),
      cudaFuncSetAttribute(slab_conv3x3<N, C16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit)};
  return i;
}

// the instantiation for Cout and Cin (multiples of 16 up to 64: takes())
const Instance& instance_of(int cin, int cout) {
  switch (cout / 16 * 8 + cin / 16) {
#define KS_CASE(N, C16) \
  case N / 16 * 8 + C16: return instance<N, C16>();
    KS_CASE(16, 1) KS_CASE(16, 2) KS_CASE(16, 3) KS_CASE(16, 4)
    KS_CASE(32, 1) KS_CASE(32, 2) KS_CASE(32, 3) KS_CASE(32, 4)
    KS_CASE(48, 1) KS_CASE(48, 2) KS_CASE(48, 3) KS_CASE(48, 4)
    KS_CASE(64, 1) KS_CASE(64, 2) KS_CASE(64, 3)
#undef KS_CASE
    default: return instance<64, 4>();  // the one case left
  }
}

}  // namespace

// Dynamic shared memory of one block of the slab kernel (0: the layout does
// not fit), for the wrapper's tests to hold its plan against.
extern "C" long long ks_conv3x3_slab_smem(int w, int cin, int cout, int rows) {
  const Layout l = layout_of(w, cin, cout, rows);
  return l.bytes <= static_cast<uint32_t>(kSmemLimit) ? l.bytes : 0;
}

// Blocks of the slab kernel one SM holds at once at this layout, by its
// threads, registers and shared memory (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the wrapper's tests to
// hold its plan's grid against.
extern "C" int ks_conv3x3_slab_blocks_per_sm(int w, int cin, int cout, int rows, int* per_sm) {
  if (!takes(nullptr, nullptr, 1, w, cin, cout, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Instance& i = instance_of(cin, cout);
  if (i.attr != cudaSuccess) return static_cast<int>(i.attr);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, i.fn, i.threads, layout_of(w, cin, cout, rows).bytes));
}

// x (B, H, W, Cin) and w (9 Cin, Cout) bf16, contiguous; bias (Cout,) f32; y
// (B, H, W, Cout) bf16. rows: R of a band (even); grid: the resident blocks
// that walk the B ceil(H / R) bands. Pixel rows of 32, 64 or 128 bytes are
// swizzled in shared memory (hopper::encode_bf16_nhwc), others not.
// cudaErrorInvalidValue, and nothing launched, when the kernel does not take
// the call or a tensor map cannot be made.
extern "C" int ks_conv3x3_slab(const void* x, const void* w, const void* bias, void* y, int batch,
                               int h, int w_, int cin, int cout, int relu, int rows, int grid,
                               void* stream) {
  if (!takes(x, y, h, w_, cin, cout, rows) || batch < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Slab s{};
  s.w = static_cast<const bf16*>(w);
  s.bias = static_cast<const float*>(bias);
  s.h = h;
  s.w_ = w_;
  s.relu = relu;
  s.rows = rows;
  s.winv = ((1ull << 32) + w_ - 1) / w_;
  s.bands = (h + rows - 1) / rows;
  s.items = batch * s.bands;
  s.swx = hopper::swizzle_mask(cin * 2);
  s.swy = hopper::swizzle_mask(cout * 2);
  s.l = layout_of(w_, cin, cout, rows);
  CUtensorMap xm, ym;
  if (hopper::encode_bf16_nhwc(&xm, x, batch, h, w_, cin, w_ + 2, rows + 2) ||
      hopper::encode_bf16_nhwc(&ym, y, batch, h, w_, cout, w_, rows / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Instance& i = instance_of(cin, cout);
  if (i.attr != cudaSuccess) return static_cast<int>(i.attr);
  void* args[] = {&s, &xm, &ym};
  return static_cast<int>(cudaLaunchKernel(i.fn, grid < s.items ? grid : s.items, i.threads, args,
                                           s.l.bytes, static_cast<cudaStream_t>(stream)));
}
