// Kuro Siwo, PyTorch port — native tile decoder + prefetch pool; the port's
// own copy of the JAX package's native/tile_decoder.cpp (the same code).
//
// Replaces the reference's per-sample cv2.imread loop
// (dataset/Dataset.py:660-768 of the reference: 7-9 small GeoTIFF reads per
// sample on the Python hot path) with a C++ thread pool decoding whole
// batches of tiles concurrently, exposed to Python via ctypes
// (kurosiwo_torch/data/native.py).
//
// libtiff is bound with dlopen at load time (no headers needed): the needed
// subset of its (stable) C ABI is declared here. Supported tile flavors match
// the Kuro Siwo products: single-band float32 (IVV/IVH), uint8 (MLU/MNA),
// uint16/int16 DEM; strip- or tile-organized; any libtiff-supported
// compression.
//
// Build (data/native.py does it at first use, into kurosiwo_torch/_build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libks_tiles.so tile_decoder.cpp -ldl -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

// ---- minimal libtiff ABI ---------------------------------------------------

extern "C" {
typedef struct tiff TIFF;
typedef TIFF *(*TIFFOpen_t)(const char *, const char *);
typedef void (*TIFFClose_t)(TIFF *);
typedef int (*TIFFGetField_t)(TIFF *, uint32_t, ...);
typedef int (*TIFFReadScanline_t)(TIFF *, void *, uint32_t, uint16_t);
typedef int (*TIFFReadEncodedStrip_t)(TIFF *, uint32_t, void *, int64_t);
typedef int (*TIFFReadEncodedTile_t)(TIFF *, uint32_t, void *, int64_t);
typedef int64_t (*TIFFStripSize_t)(TIFF *);
typedef int64_t (*TIFFTileSize_t)(TIFF *);
typedef int (*TIFFIsTiled_t)(TIFF *);
typedef uint32_t (*TIFFNumberOfStrips_t)(TIFF *);
typedef void (*TIFFSetHandler_t)(void *);
}

// TIFF tag ids (from the TIFF 6.0 spec)
enum {
  TAG_IMAGEWIDTH = 256,
  TAG_IMAGELENGTH = 257,
  TAG_BITSPERSAMPLE = 258,
  TAG_SAMPLESPERPIXEL = 277,
  TAG_ROWSPERSTRIP = 278,
  TAG_SAMPLEFORMAT = 339,
  TAG_TILEWIDTH = 322,
  TAG_TILELENGTH = 323,
};
enum { FMT_UINT = 1, FMT_INT = 2, FMT_IEEEFP = 3 };

namespace {

struct TiffApi {
  TIFFOpen_t Open = nullptr;
  TIFFClose_t Close = nullptr;
  TIFFGetField_t GetField = nullptr;
  TIFFReadScanline_t ReadScanline = nullptr;
  TIFFReadEncodedStrip_t ReadEncodedStrip = nullptr;
  TIFFReadEncodedTile_t ReadEncodedTile = nullptr;
  TIFFStripSize_t StripSize = nullptr;
  TIFFTileSize_t TileSize = nullptr;
  TIFFIsTiled_t IsTiled = nullptr;
  TIFFNumberOfStrips_t NumberOfStrips = nullptr;
  bool ok = false;
};

TiffApi &api() {
  static TiffApi a = [] {
    TiffApi t;
    void *h = dlopen("libtiff.so.6", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libtiff.so.5", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libtiff.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return t;
    t.Open = (TIFFOpen_t)dlsym(h, "TIFFOpen");
    t.Close = (TIFFClose_t)dlsym(h, "TIFFClose");
    t.GetField = (TIFFGetField_t)dlsym(h, "TIFFGetField");
    t.ReadScanline = (TIFFReadScanline_t)dlsym(h, "TIFFReadScanline");
    t.ReadEncodedStrip = (TIFFReadEncodedStrip_t)dlsym(h, "TIFFReadEncodedStrip");
    t.ReadEncodedTile = (TIFFReadEncodedTile_t)dlsym(h, "TIFFReadEncodedTile");
    t.StripSize = (TIFFStripSize_t)dlsym(h, "TIFFStripSize");
    t.TileSize = (TIFFTileSize_t)dlsym(h, "TIFFTileSize");
    t.IsTiled = (TIFFIsTiled_t)dlsym(h, "TIFFIsTiled");
    t.NumberOfStrips = (TIFFNumberOfStrips_t)dlsym(h, "TIFFNumberOfStrips");
    // silence warning handlers (optional symbols)
    using SetH = void *(*)(void *);
    if (auto f = (SetH)dlsym(h, "TIFFSetWarningHandler")) f(nullptr);
    t.ok = t.Open && t.Close && t.GetField && t.ReadScanline;
    return t;
  }();
  return a;
}

inline float to_float(const uint8_t *src, int fmt, int bits, int64_t i) {
  if (fmt == FMT_IEEEFP && bits == 32) return ((const float *)src)[i];
  if (fmt == FMT_IEEEFP && bits == 64) return (float)((const double *)src)[i];
  if (bits == 8) return fmt == FMT_INT ? (float)((const int8_t *)src)[i] : (float)src[i];
  if (bits == 16)
    return fmt == FMT_INT ? (float)((const int16_t *)src)[i] : (float)((const uint16_t *)src)[i];
  if (bits == 32)
    return fmt == FMT_INT ? (float)((const int32_t *)src)[i] : (float)((const uint32_t *)src)[i];
  return 0.0f;
}

// decode one single-plane image into out (row-major, float32, interleaved C)
int decode_one(const char *path, float *out, int64_t capacity, int32_t *oh, int32_t *ow,
               int32_t *oc) {
  TiffApi &t = api();
  if (!t.ok) return -1;
  TIFF *tif = t.Open(path, "r");
  if (!tif) return -2;
  uint32_t w = 0, h = 0;
  uint16_t bits = 8, spp = 1, fmt = FMT_UINT;
  t.GetField(tif, TAG_IMAGEWIDTH, &w);
  t.GetField(tif, TAG_IMAGELENGTH, &h);
  t.GetField(tif, TAG_BITSPERSAMPLE, &bits);
  t.GetField(tif, TAG_SAMPLESPERPIXEL, &spp);
  if (!t.GetField(tif, TAG_SAMPLEFORMAT, &fmt)) fmt = FMT_UINT;
  if (spp == 0) spp = 1;
  const int64_t need = (int64_t)w * h * spp;
  if (need > capacity || w == 0 || h == 0) {
    t.Close(tif);
    *oh = (int32_t)h; *ow = (int32_t)w; *oc = (int32_t)spp;
    return need > capacity ? -3 : -4;
  }
  const int bytes_per = bits / 8;
  int rc = 0;
  if (t.IsTiled && t.IsTiled(tif)) {
    uint32_t tw = 0, th = 0;
    t.GetField(tif, TAG_TILEWIDTH, &tw);
    t.GetField(tif, TAG_TILELENGTH, &th);
    const int64_t tsize = t.TileSize(tif);
    std::vector<uint8_t> buf(tsize);
    uint32_t tile = 0;
    for (uint32_t y0 = 0; y0 < h && rc == 0; y0 += th) {
      for (uint32_t x0 = 0; x0 < w && rc == 0; x0 += tw, ++tile) {
        if (t.ReadEncodedTile(tif, tile, buf.data(), tsize) < 0) { rc = -5; break; }
        const uint32_t ylim = std::min(th, h - y0), xlim = std::min(tw, w - x0);
        for (uint32_t y = 0; y < ylim; ++y)
          for (uint32_t x = 0; x < xlim; ++x)
            for (uint16_t c = 0; c < spp; ++c)
              out[(((int64_t)(y0 + y) * w) + (x0 + x)) * spp + c] =
                  to_float(buf.data(), fmt, bits, ((int64_t)y * tw + x) * spp + c);
      }
    }
  } else {
    std::vector<uint8_t> row((int64_t)w * spp * bytes_per);
    for (uint32_t y = 0; y < h; ++y) {
      if (t.ReadScanline(tif, row.data(), y, 0) < 0) { rc = -5; break; }
      for (int64_t i = 0; i < (int64_t)w * spp; ++i)
        out[(int64_t)y * w * spp + i] = to_float(row.data(), fmt, bits, i);
    }
  }
  t.Close(tif);
  *oh = (int32_t)h; *ow = (int32_t)w; *oc = (int32_t)spp;
  return rc;
}

// ---- thread pool -----------------------------------------------------------

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

Pool *g_pool = nullptr;
std::mutex g_pool_mu;

Pool &pool(int threads) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (!g_pool) g_pool = new Pool(threads > 0 ? threads : (int)std::thread::hardware_concurrency());
  return *g_pool;
}

}  // namespace

// ---- C API -----------------------------------------------------------------

extern "C" {

int ks_available() { return api().ok ? 1 : 0; }

// Decode one tile to float32; returns 0 on success.
int ks_decode(const char *path, float *out, int64_t capacity, int32_t *h, int32_t *w,
              int32_t *c) {
  return decode_one(path, out, capacity, h, w, c);
}

// Decode a batch of n tiles concurrently. Each tile i writes into
// out + i*stride (stride in floats). dims is n*3 ints (h, w, c per tile);
// rcs is n return codes. threads<=0 -> hardware concurrency.
void ks_decode_batch(const char **paths, int n, float *out, int64_t stride, int32_t *dims,
                     int32_t *rcs, int threads) {
  Pool &p = pool(threads);
  std::atomic<int> remaining(n);
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < n; ++i) {
    p.submit([&, i] {
      rcs[i] = decode_one(paths[i], out + (int64_t)i * stride, stride, &dims[i * 3],
                          &dims[i * 3 + 1], &dims[i * 3 + 2]);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
}

}  // extern "C"
