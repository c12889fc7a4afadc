// Native frame wire conversion for the port's ingest path (the port's own
// copy of the JAX package's native/framewire.cpp, loaded by ctypes from
// io/framewire.py, whose numpy branches are the reference).
//
// Built with -ffp-contract=off: every expression rounds op by op, in the
// order of its numpy twin, so the conversions give the twin's bytes.
//
// The bilateral shares nothing mutable between threads: its spatial weights
// come from the caller (computed there exactly as the numpy twin computes
// them) and are read-only inside the parallel region, and each range weight
// is computed per tap from the two float32 depths, as the twin computes it.
// (A range table keyed on the integer mm difference cannot reproduce the
// twin's float32 difference of two rounded depths; a table kept per thread
// and filled only on the calling thread leaves every other thread's copy
// zero.)

#include <cmath>
#include <cstdint>

extern "C" {

// v1 wire: float depth (m) [h*w] + float RGB [h*w*3] -> uint16 mm + uint8.
void frame_to_wire(const float* depth, const float* color, long h, long w, uint16_t* d16, uint8_t* c8) {
  const long n = h * w;
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    float d = depth[i];
    d = d < 0.f ? 0.f : (d > 65.f ? 65.f : d);
    d16[i] = (uint16_t)(d * 1000.f + 0.5f);
  }
  const long m = 3 * n;
#pragma omp parallel for schedule(static)
  for (long i = 0; i < m; ++i) {
    float v = color[i];
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    c8[i] = (uint8_t)(v * 255.f + 0.5f);
  }
}

// v2 wire: uint16 mm depth (0 outside [d_min, d_max]), full-res uint8 luma,
// half-res uint8 RGB (2x2 box mean). h and w are even.
void frame_to_wire2(const float* depth, const float* color, long h, long w, float d_min, float d_max,
                    uint16_t* d16, uint8_t* y8, uint8_t* c8h) {
  const long n = h * w;
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    float d = depth[i];
    if (!(d >= d_min && d <= d_max)) d = 0.f;
    d16[i] = (uint16_t)(d * 1000.f + 0.5f);
  }
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    const float* c = color + 3 * i;
    float v = c[0] * 0.299f + c[1] * 0.587f + c[2] * 0.114f;
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    y8[i] = (uint8_t)(v * 255.f + 0.5f);
  }
  const long h2 = h / 2, w2 = w / 2;
#pragma omp parallel for schedule(static)
  for (long y = 0; y < h2; ++y) {
    const float* r0 = color + (2 * y) * w * 3;
    const float* r1 = color + (2 * y + 1) * w * 3;
    uint8_t* out = c8h + y * w2 * 3;
    for (long x = 0; x < w2; ++x) {
      const float* a = r0 + 6 * x;
      const float* b = r1 + 6 * x;
      for (int ch = 0; ch < 3; ++ch) {
        float v = 0.25f * (((a[ch] + a[3 + ch]) + b[ch]) + b[3 + ch]);
        v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
        out[3 * x + ch] = (uint8_t)(v * 255.f + 0.5f);
      }
    }
  }
}

// 12-bit depth: 2 pixels -> 3 bytes (values < 4096). n is even.
void pack_depth12(const uint16_t* d16, long n, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n / 2; ++i) {
    const uint16_t p0 = d16[2 * i], p1 = d16[2 * i + 1];
    out[3 * i] = (uint8_t)(p0 & 0xFF);
    out[3 * i + 1] = (uint8_t)((p0 >> 8) | ((p1 & 0xF) << 4));
    out[3 * i + 2] = (uint8_t)(p1 >> 4);
  }
}

// 5x5 zero-aware bilateral on uint16 mm depth. spatial[25]: the float64
// spatial weights in tap order (dy outer, dx inner, each -2..2; the tap
// (dy, dx) reads the pixel (y - dy, x - dx)). inv_2sr2 = 1 / (2 sigma_r^2)
// as a float32. Each tap's weight and weighted depth are float64 and each
// accumulator add rounds to float32, as in the numpy twin.
void bilateral_wire_u16(const uint16_t* in, long h, long w, const double* spatial, float inv_2sr2,
                        uint16_t* out) {
#pragma omp parallel for schedule(static)
  for (long y = 0; y < h; ++y) {
    for (long x = 0; x < w; ++x) {
      const int dmm = in[y * w + x];
      if (dmm == 0) {
        out[y * w + x] = 0;
        continue;
      }
      const float d = (float)dmm * 1e-3f;
      float acc = 0.f, wacc = 0.f;
      for (int dy = -2; dy <= 2; ++dy) {
        const long yy = y - dy;
        if (yy < 0 || yy >= h) continue;
        for (int dx = -2; dx <= 2; ++dx) {
          const long xx = x - dx;
          if (xx < 0 || xx >= w) continue;
          const int nmm = in[yy * w + xx];
          if (nmm == 0) continue;  // weight 0: the twin's sums do not move
          const float nd = (float)nmm * 1e-3f;
          const float diff = nd - d;
          const float wr = std::exp(-(diff * diff) * inv_2sr2);
          const double wt = spatial[(dy + 2) * 5 + (dx + 2)] * (double)wr;
          acc = (float)((double)acc + wt * (double)nd);
          wacc = (float)((double)wacc + wt);
        }
      }
      const float f = acc / (wacc > 1e-12f ? wacc : 1e-12f);
      float mm = f * 1000.f + 0.5f;
      mm = mm < 0.f ? 0.f : (mm > 65535.f ? 65535.f : mm);
      out[y * w + x] = (uint16_t)mm;
    }
  }
}

}  // extern "C"
