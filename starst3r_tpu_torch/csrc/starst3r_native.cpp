// Native host-side runtime for starst3r-tpu.
//
// The reference offloads its hot host-side work to native code in its
// vendored deps (CUDA extensions; torchvision's C++ image ops behind
// starster/image.py). The TPU build keeps device compute in XLA/Pallas and
// implements the host runtime natively here:
//
//   * st_preprocess        — bicubic longest-edge resize + center-crop to a
//                            multiple + mean/std normalize, HWC u8 -> CHW f32
//                            (the pipeline of reference starster/image.py:43-109)
//   * st_preprocess_batch  — the same over N images on a pthread pool (the
//                            data-loader hot loop feeding pairwise inference)
//   * st_hash64            — FNV-1a 64-bit content hash (pair-cache keys)
//   * st_rgb_to_u8         — float [0,1] HWC -> u8 with rounding (PNG dump)
//
// Built as a plain shared library; Python binds via ctypes
// (starst3r_tpu/native/__init__.py). No Python.h dependency.
//
// Resize uses the same convolution-based approach as PIL: a Catmull-Rom
// (a = -0.5) cubic kernel whose support is scaled by the downsampling
// factor (antialias), applied separably. Matches PIL.Image.BICUBIC output
// to within rounding.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>
#include <thread>
#include <atomic>

extern "C" {

static inline double cubic(double x) {
  // Catmull-Rom (a = -0.5), PIL's bicubic kernel
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precomputed sampling weights for one output axis.
struct AxisWeights {
  int ksize;                 // taps per output pixel
  std::vector<int> bounds;   // (out, 2): first tap index, tap count
  std::vector<double> weights;  // (out, ksize)
};

static AxisWeights compute_weights(int in_size, int out_size) {
  AxisWeights aw;
  double scale = (double)in_size / out_size;
  double filterscale = std::max(scale, 1.0);   // antialias on downscale
  double support = 2.0 * filterscale;          // cubic support = 2
  aw.ksize = (int)std::ceil(support) * 2 + 1;
  aw.bounds.resize(out_size * 2);
  aw.weights.assign((size_t)out_size * aw.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)std::max(center - support + 0.5, 0.0);
    int xmax = std::min((int)(center + support + 0.5), in_size);
    double* w = &aw.weights[(size_t)xx * aw.ksize];
    double ss = 0.0;
    int n = xmax - xmin;
    for (int x = 0; x < n; ++x) {
      double ww = cubic((x + xmin - center + 0.5) / filterscale);
      w[x] = ww;
      ss += ww;
    }
    if (ss != 0.0)
      for (int x = 0; x < n; ++x) w[x] /= ss;
    aw.bounds[xx * 2] = xmin;
    aw.bounds[xx * 2 + 1] = n;
  }
  return aw;
}

// Bicubic resize HWC u8 -> HWC float (separable, horizontal then vertical).
static void resize_bicubic(const uint8_t* src, int h, int w, int c,
                           float* dst, int oh, int ow) {
  AxisWeights wx = compute_weights(w, ow);
  AxisWeights wy = compute_weights(h, oh);
  std::vector<double> tmp((size_t)h * ow * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + (size_t)y * w * c;
    for (int xx = 0; xx < ow; ++xx) {
      int x0 = wx.bounds[xx * 2], n = wx.bounds[xx * 2 + 1];
      const double* wgt = &wx.weights[(size_t)xx * wx.ksize];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int k = 0; k < n; ++k)
          acc += row[(size_t)(x0 + k) * c + ch] * wgt[k];
        // PIL's 8-bit path quantizes the intermediate image back to u8
        // between the horizontal and vertical passes — reproduce for parity
        acc = std::floor(std::min(std::max(acc, 0.0), 255.0) + 0.5);
        tmp[((size_t)y * ow + xx) * c + ch] = acc;
      }
    }
  }
  for (int yy = 0; yy < oh; ++yy) {
    int y0 = wy.bounds[yy * 2], n = wy.bounds[yy * 2 + 1];
    const double* wgt = &wy.weights[(size_t)yy * wy.ksize];
    for (int xx = 0; xx < ow; ++xx) {
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int k = 0; k < n; ++k)
          acc += tmp[((size_t)(y0 + k) * ow + xx) * c + ch] * wgt[k];
        // PIL clips to [0, 255] and rounds when converting back to u8
        acc = std::floor(std::min(std::max(acc, 0.0), 255.0) + 0.5);
        dst[((size_t)yy * ow + xx) * c + ch] = (float)acc;
      }
    }
  }
}

// Full pipeline for one image. Returns 0 on success.
// out must hold 3 * out_h * out_w floats where out_h/out_w are the
// crop-adjusted sizes (query with st_preprocess_shape first).
int st_preprocess_shape(int h, int w, int size, int crop_mult,
                        int* out_h, int* out_w) {
  double scale = (double)size / std::max(h, w);
  int nh = (int)(h * scale), nw = (int)(w * scale);
  int cy = nh / 2, cx = nw / 2;
  int hh = (cy / crop_mult) * crop_mult;
  int wh = (cx / crop_mult) * crop_mult;
  *out_h = 2 * hh;
  *out_w = 2 * wh;
  return (*out_h > 0 && *out_w > 0) ? 0 : 1;
}

int st_preprocess(const uint8_t* rgb, int h, int w, int size, int crop_mult,
                  float mean, float stdv, float* out) {
  double scale = (double)size / std::max(h, w);
  int nh = (int)(h * scale), nw = (int)(w * scale);
  std::vector<float> resized((size_t)nh * nw * 3);
  resize_bicubic(rgb, h, w, 3, resized.data(), nh, nw);
  int cy = nh / 2, cx = nw / 2;
  int hh = (cy / crop_mult) * crop_mult;
  int wh = (cx / crop_mult) * crop_mult;
  int oh = 2 * hh, ow = 2 * wh;
  if (oh <= 0 || ow <= 0) return 1;
  int y0 = cy - hh, x0 = cx - wh;
  float inv = 1.0f / (255.0f * stdv);
  float off = mean / stdv;
  // crop + normalize + HWC->CHW
  for (int ch = 0; ch < 3; ++ch) {
    float* dst = out + (size_t)ch * oh * ow;
    for (int y = 0; y < oh; ++y) {
      const float* src = resized.data() + ((size_t)(y0 + y) * nw + x0) * 3 + ch;
      for (int x = 0; x < ow; ++x)
        dst[(size_t)y * ow + x] = src[(size_t)x * 3] * inv - off;
    }
  }
  return 0;
}

// Batch version over a thread pool. imgs: array of N pointers; hs/ws: dims;
// outs: array of N output pointers (each preallocated per
// st_preprocess_shape). Returns count of failures.
int st_preprocess_batch(const uint8_t** imgs, const int* hs, const int* ws,
                        int n, int size, int crop_mult, float mean,
                        float stdv, float** outs, int n_threads) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next(0), fails(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (st_preprocess(imgs[i], hs[i], ws[i], size, crop_mult, mean, stdv,
                        outs[i]) != 0)
        fails.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return fails.load();
}

uint64_t st_hash64(const uint8_t* data, uint64_t len, uint64_t seed) {
  // FNV-1a 64
  uint64_t hashv = 1469598103934665603ULL ^ seed;
  for (uint64_t i = 0; i < len; ++i) {
    hashv ^= data[i];
    hashv *= 1099511628211ULL;
  }
  return hashv;
}

void st_rgb_to_u8(const float* rgb, int n, uint8_t* out) {
  for (int i = 0; i < n; ++i) {
    float v = rgb[i] * 255.0f + 0.5f;
    out[i] = (uint8_t)std::min(std::max(v, 0.0f), 255.0f);
  }
}

}  // extern "C"
