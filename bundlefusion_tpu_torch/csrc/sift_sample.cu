// SIFT's window sampling in one launch: for every key and each point of its
// 16x16 window, the bilinear sample of both gradient planes and the point's
// mask, read straight from the octave's packed gradient image.
//
// Replaces the XLA einsums of bundlefusion_tpu/features/sift.py::
// _sample_in_patches (via _gather_grads_patches; no Pallas kernel there: the
// port's own H100 profile put its dense tent-weight contractions at 25% of
// the card's time). Its plain PyTorch twin is bundlefusion_tpu_torch/
// features/sift.py::_sample_window_torch, the 4-tap gather form.
//
// What bounds it on an H100: bytes. Per point it reads the coordinates
// (8 B) and four packed taps (mostly from cache: a key's window lies in its
// 64x128 patch) and writes gx, gy and the mask (9 B); ~40 flops.
//
// Design: one thread per window point. The key's patch origin is clamped as
// the patch gather clamps it (rows to [0, Ht - 64], 64-column blocks to
// [0, nb - 2]), and the taps are read from the tall image at that origin,
// exactly where the [64, 128] patch would hold them. The arithmetic is the
// twin's, op by op under --fmad=false: the clamps (NaN passes through),
// l0 = floor(l) (a NaN gives 0 and NaN weights), the tents clamp(1 - |l -
// l0|, 0) and clamp(1 - |l - (l0 + 1)|, 0), each tap unpacked as
// _unpack_grads does, rows first, then columns.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPatch = 64, kPatchW = 128, kBlk = 64;

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float tent(float l, float at) {
  const float t = 1.0f - fabsf(l - at);
  return isnan(t) ? t : fmaxf(t, 0.0f);
}

__device__ __forceinline__ void unpack(float packed, float& gx, float& gy) {
  const float qx = floorf(packed * (1.0f / 4096.0f));
  const float qy = packed - qx * 4096.0f;
  const float inv = (float)(1.0 / 4095.0);
  gx = qx * inv - 0.5f;
  gy = qy * inv - 0.5f;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) sift_sample_kernel(
    const float* __restrict__ tall, const float* __restrict__ coords, const long long* __restrict__ x0,
    const long long* __restrict__ y0, const long long* __restrict__ row0, float* __restrict__ gx,
    float* __restrict__ gy, bool* __restrict__ mask, long long total, int keys, int points, int ht, int wp,
    float x_max, float y_max, float lx_max, float ly_max) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const long long key = p / points;
  const long long frame = key / keys;
  const float x = coords[2 * p], y = coords[2 * p + 1];
  const long long kx0 = x0[key], ky0 = y0[key];

  const bool inb = (x >= 0.0f) & (x <= x_max) & (y >= 0.0f) & (y <= y_max);
  const float rx = x - (float)kx0, ry = y - (float)ky0;
  const float lx = clamp_nan(rx, 0.0f, lx_max), ly = clamp_nan(ry, 0.0f, ly_max);
  const bool in_patch = (rx >= 0.0f) & (rx < (float)(kPatchW - 1)) & (ry >= 0.0f) & (ry < (float)(kPatch - 1));

  // the patch origin as the patch gather clamps it
  const long long r0 = clamp_ll(row0[key], 0, ht - kPatch);
  const long long blk = kx0 >= 0 ? kx0 / kBlk : -((-kx0 + kBlk - 1) / kBlk);  // floor division
  const long long c0 = clamp_ll(blk, 0, wp / kBlk - kPatchW / kBlk) * kBlk;

  float lx0 = floorf(lx), ly0 = floorf(ly);
  lx0 = isnan(lx0) ? 0.0f : lx0;
  ly0 = isnan(ly0) ? 0.0f : ly0;
  const float ty0 = tent(ly, ly0), ty1 = tent(ly, ly0 + 1.0f);
  const float tx0 = tent(lx, lx0), tx1 = tent(lx, lx0 + 1.0f);

  const float* t = tall + ((size_t)frame * ht + (size_t)(r0 + (long long)ly0)) * wp + (size_t)(c0 + (long long)lx0);
  float ax, ay, bx, by, cx, cy, dx, dy;
  unpack(__ldg(t), ax, ay);           // (l0y, l0x)
  unpack(__ldg(t + wp), bx, by);      // (l0y + 1, l0x)
  unpack(__ldg(t + 1), cx, cy);       // (l0y, l0x + 1)
  unpack(__ldg(t + wp + 1), dx, dy);  // (l0y + 1, l0x + 1)
  const float col0x = ty0 * ax + ty1 * bx, col1x = ty0 * cx + ty1 * dx;
  const float col0y = ty0 * ay + ty1 * by, col1y = ty0 * cy + ty1 * dy;
  gx[p] = col0x * tx0 + col1x * tx1;
  gy[p] = col0y * tx0 + col1y * tx1;
  mask[p] = inb & in_patch;
}

}  // namespace

extern "C" int bf_sift_sample(const float* tall, const float* coords, const long long* x0, const long long* y0,
                              const long long* row0, float* gx, float* gy, bool* mask, int frames, int keys,
                              int points, int ht, int wp, float x_max, float y_max, float lx_max, float ly_max,
                              void* stream) {
  const long long total = (long long)frames * keys * points;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  sift_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(tall, coords, x0, y0, row0, gx, gy, mask, total,
                                                                    keys, points, ht, wp, x_max, y_max, lx_max,
                                                                    ly_max);
  return (int)cudaGetLastError();
}
