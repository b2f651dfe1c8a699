// Host-side image resize of the train stage's input pipeline: a copy of the
// resize of saspa_tpu/native/saspa_host.cpp (the JAX package's native host
// library), kept here so the port builds it itself.  The arithmetic must stay
// as it is there: the pipeline's pixels are held equal to the JAX package's.
//
// Build: saspa_tpu_torch/ops/host_resize.py (g++ -O3 -march=native -std=c++17
// -shared -fPIC, the JAX package's flags), at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// resize, uint8 HWC -> uint8 HWC: area-average on downscale (antialiased,
// matches PIL/cv2.INTER_AREA closely), half-pixel bilinear on upscale
// ---------------------------------------------------------------------------
static void resize_area(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  std::vector<float> acc(c);
  for (int y = 0; y < dh; ++y) {
    float fy0 = y * sy, fy1 = (y + 1) * sy;
    int iy0 = static_cast<int>(std::floor(fy0));
    int iy1 = std::min(sh, static_cast<int>(std::ceil(fy1)));
    for (int x = 0; x < dw; ++x) {
      float fx0 = x * sx, fx1 = (x + 1) * sx;
      int ix0 = static_cast<int>(std::floor(fx0));
      int ix1 = std::min(sw, static_cast<int>(std::ceil(fx1)));
      std::fill(acc.begin(), acc.end(), 0.0f);
      float total_w = 0.0f;
      for (int yy = iy0; yy < iy1; ++yy) {
        float wy = std::min(fy1, static_cast<float>(yy + 1)) - std::max(fy0, static_cast<float>(yy));
        for (int xx = ix0; xx < ix1; ++xx) {
          float wx = std::min(fx1, static_cast<float>(xx + 1)) - std::max(fx0, static_cast<float>(xx));
          float wgt = wy * wx;
          total_w += wgt;
          const uint8_t* p = src + (yy * sw + xx) * c;
          for (int ch = 0; ch < c; ++ch) acc[ch] += wgt * p[ch];
        }
      }
      uint8_t* out = dst + (y * dw + x) * c;
      for (int ch = 0; ch < c; ++ch)
        out[ch] = static_cast<uint8_t>(acc[ch] / std::max(total_w, 1e-9f) + 0.5f);
    }
  }
}

static void resize_one(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  if (dh < sh && dw < sw) {
    resize_area(src, sh, sw, c, dst, dh, dw);
    return;
  }
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, static_cast<int>(std::floor(fy))));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = std::min(1.0f, std::max(0.0f, fy - y0));
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, static_cast<int>(std::floor(fx))));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = std::min(1.0f, std::max(0.0f, fx - x0));
      for (int ch = 0; ch < c; ++ch) {
        float top = src[(y0 * sw + x0) * c + ch] * (1 - wx) +
                    src[(y0 * sw + x1) * c + ch] * wx;
        float bot = src[(y1 * sw + x0) * c + ch] * (1 - wx) +
                    src[(y1 * sw + x1) * c + ch] * wx;
        float v = top * (1 - wy) + bot * wy;
        dst[(y * dw + x) * c + ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  resize_one(src, sh, sw, c, dst, dh, dw);
}

}  // extern "C"
