// Native data-pipeline kernels for tfcgan_tpu.
//
// The reference's host-side per-sample work (side-by-side pair split +
// bicubic resize + [-1,1] normalize + temperature LUT,
// /root/reference/TFC-GAN-FFT/datasets_temp.py:49-119) runs through PIL one
// image at a time. This C++ implementation reproduces PIL's resize algorithm
// (separable convolution with the Catmull-Rom bicubic kernel a=-0.5 and
// support widening on downscale — the same math as Pillow's
// ImagingResampleHorizontal/Vertical) and fuses split+resize+normalize+LUT
// into one threaded pass, exposed via a C ABI for ctypes.
//
// Build: native/build.sh (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kA = -0.5;  // PIL BICUBIC kernel parameter

double bicubic(double x) {
  x = std::abs(x);
  if (x < 1.0) return ((kA + 2.0) * x - (kA + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * kA;
  return 0.0;
}

struct Weights {
  // For each output position: first source index + normalized taps.
  std::vector<int> bounds;     // 2 per output (start, size)
  std::vector<double> coeffs;  // ksize per output
  int ksize = 0;
};

// Mirror of Pillow's precompute_coeffs (ImagingResampleHorizontal).
Weights precompute(int in_size, int out_size) {
  Weights w;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 2.0 * filterscale;  // bicubic support = 2
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  w.ksize = ksize;
  w.bounds.resize(2 * out_size);
  w.coeffs.resize(static_cast<size_t>(ksize) * out_size);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = std::max(0, static_cast<int>(center - support + 0.5));
    int xmax = std::min(in_size, static_cast<int>(center + support + 0.5)) - xmin;
    double* k = &w.coeffs[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double weight = bicubic((x + xmin - center + 0.5) * ss);
      k[x] = weight;
      ww += weight;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = xmax; x < ksize; ++x) k[x] = 0.0;
    w.bounds[2 * xx] = xmin;
    w.bounds[2 * xx + 1] = xmax;
  }
  return w;
}

// Resize one HxWx3 uint8 image to out x out, float64 accumulation like PIL's
// fixed point (we use double; Pillow uses int32 fixed point — difference is
// sub-quantization), clamped back to uint8 semantics in float.
void resize_bicubic(const uint8_t* src, int in_h, int in_w, int stride,
                    int out_size, float* dst /* out*out*3 */) {
  Weights wh = precompute(in_w, out_size);
  Weights wv = precompute(in_h, out_size);
  // horizontal pass: (in_h, out_size, 3)
  std::vector<double> tmp(static_cast<size_t>(in_h) * out_size * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * stride;
    for (int x = 0; x < out_size; ++x) {
      int xmin = wh.bounds[2 * x];
      int xmax = wh.bounds[2 * x + 1];
      const double* k = &wh.coeffs[static_cast<size_t>(x) * wh.ksize];
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < xmax; ++i) {
        const uint8_t* px = row + static_cast<size_t>(xmin + i) * 3;
        acc[0] += px[0] * k[i];
        acc[1] += px[1] * k[i];
        acc[2] += px[2] * k[i];
      }
      double* out = &tmp[(static_cast<size_t>(y) * out_size + x) * 3];
      out[0] = acc[0];
      out[1] = acc[1];
      out[2] = acc[2];
    }
  }
  // vertical pass
  for (int y = 0; y < out_size; ++y) {
    int ymin = wv.bounds[2 * y];
    int ymax = wv.bounds[2 * y + 1];
    const double* k = &wv.coeffs[static_cast<size_t>(y) * wv.ksize];
    for (int x = 0; x < out_size; ++x) {
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < ymax; ++i) {
        const double* px = &tmp[(static_cast<size_t>(ymin + i) * out_size + x) * 3];
        acc[0] += px[0] * k[i];
        acc[1] += px[1] * k[i];
        acc[2] += px[2] * k[i];
      }
      float* out = dst + (static_cast<size_t>(y) * out_size + x) * 3;
      // PIL clips and rounds to uint8 between passes' end; emulate the final
      // quantization so results match a PIL-resized uint8 image exactly.
      for (int c = 0; c < 3; ++c) {
        double v = std::round(std::min(255.0, std::max(0.0, acc[c])));
        out[c] = static_cast<float>(v);
      }
    }
  }
}

}  // namespace

extern "C" {

// One A|B pair image (h, w, 3 uint8) -> A, B resized to (out, out, 3) uint8
// values stored as float [0,255], normalized copies in [-1,1], and the
// temperature map from B's red channel (linspace(24,38,256) LUT).
void process_pair(const uint8_t* img, int h, int w, int out_size,
                  float* a_norm, float* b_norm, float* t_b) {
  int half = w / 2;
  std::vector<float> a_u8(static_cast<size_t>(out_size) * out_size * 3);
  std::vector<float> b_u8(static_cast<size_t>(out_size) * out_size * 3);
  // crop((0,0,w/2,h)) and crop((w/2,0,w,h)) then bicubic resize
  resize_bicubic(img, h, half, w * 3, out_size, a_u8.data());
  resize_bicubic(img + static_cast<size_t>(half) * 3, h, w - half, w * 3,
                 out_size, b_u8.data());
  size_t n = static_cast<size_t>(out_size) * out_size;
  for (size_t i = 0; i < n * 3; ++i) {
    a_norm[i] = (a_u8[i] / 255.0f - 0.5f) / 0.5f;
    b_norm[i] = (b_u8[i] / 255.0f - 0.5f) / 0.5f;
  }
  const float t_scale = 14.0f / 255.0f;
  for (size_t i = 0; i < n; ++i) {
    t_b[i] = 24.0f + b_u8[i * 3] * t_scale;  // red channel
  }
}

// Threaded batch variant: images concatenated, same (h, w) per item.
void process_pair_batch(const uint8_t* imgs, int batch, int h, int w,
                        int out_size, float* a_norm, float* b_norm,
                        float* t_b, int num_threads) {
  size_t img_stride = static_cast<size_t>(h) * w * 3;
  size_t out_stride = static_cast<size_t>(out_size) * out_size * 3;
  size_t t_stride = static_cast<size_t>(out_size) * out_size;
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([=]() {
      for (int i = t; i < batch; i += num_threads) {
        process_pair(imgs + i * img_stride, h, w, out_size,
                     a_norm + i * out_stride, b_norm + i * out_stride,
                     t_b + i * t_stride);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
