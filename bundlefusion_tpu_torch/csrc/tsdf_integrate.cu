// TSDF integrate / exact de-integrate of one update row of 8^3 blocks.
//
// Replaces the Pallas TPU kernel bundlefusion_tpu/fusion/pallas_tsdf.py::_kernel
// (entry point integrate_blocks_pallas_planar). Its plain PyTorch twin is
// bundlefusion_tpu_torch/fusion/tsdf.py::_integrate_blocks_torch.
//
// What bounds it on an H100: device memory. Each updated block reads and
// writes its sdf, weight and colour rows (20 B per voxel each way, ~20 KB
// per block); the per-voxel arithmetic (one projection, one divide) is a
// few dozen flops, far below the card's ratio of ~20 flops per byte in f32.
// The depth and colour images (1.2 MB + 0.23 MB at 640x480) stay in L2.
//
// Design:
//   * one CUDA block per update slot, 512 threads, one voxel per thread;
//     voxel v = z*64 + y*8 + x, so a warp's pool reads and writes are
//     contiguous 128-byte lines in the planar [C+1, 512] / [C+1, 1536]
//     pools (colour element ch*512 + v).
//   * a masked slot returns before any read or write: masked rows never
//     touch the scratch row, so 4,000 idle blocks cost only their launch.
//   * the slots of one row are unique (each row's update keys are deduped),
//     so blocks never write the same row: no atomics, and integrate followed
//     by de-integrate restores the weights exactly.
//   * depth (f32 [H, W]) and the half-res uint8 colour ([Hc, Wc, 3]) are
//     sampled directly at the nearest pixel floor(u + 0.5); the TPU kernel's
//     one-hot MXU sampling, bf16 depth planes and sampling windows are gone,
//     so no voxel is ever dropped for lying outside a window.
//   * the pose (w2c 3x4), the intrinsics and the row's sign come from a
//     device float[17]: the host never reads them, so a row costs no sync.
//   * built with --fmad=false: the projection and the running mean are
//     rounded op by op in the twin's order, so a voxel within one ulp of a
//     pixel or truncation edge lands on the same side in kernel and twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNvox = 512;
constexpr int kOff = 512;

struct FuseScalars {
  float voxel_size;   // f32(voxel_size)
  float block_m;      // f32(8 * voxel_size)
  float trunc_base;   // truncation
  float trunc_scale;  // truncation_scale
  float max_dist;     // max_integration_distance
  float max_weight;   // max_integration_weight
  float w_sample;     // integration_weight_sample
  float inv255;       // f32(1 / 255)
};

__global__ void tsdf_integrate_kernel(
    float* __restrict__ sdf, float* __restrict__ weight, float* __restrict__ color,
    const int32_t* __restrict__ key_of_slot, const int32_t* __restrict__ slots,
    const uint8_t* __restrict__ mask, const float* __restrict__ depth, int H, int W,
    const uint8_t* __restrict__ color_img, int Hc, int Wc,
    const float* __restrict__ params, FuseScalars s) {
  const int b = blockIdx.x;
  if (!mask[b]) return;
  const int slot = slots[b];
  const int key = key_of_slot[slot];
  const int bx = (key & 1023) - kOff;
  const int by = ((key >> 10) & 1023) - kOff;
  const int bz = ((key >> 20) & 1023) - kOff;

  const int v = threadIdx.x;
  const int lx = v & 7, ly = (v >> 3) & 7, lz = v >> 6;
  // voxel centre: block origin + (l + 0.5) * voxel (blocks.voxel_centers)
  const float wx = (float)bx * s.block_m + ((float)lx + 0.5f) * s.voxel_size;
  const float wy = (float)by * s.block_m + ((float)ly + 0.5f) * s.voxel_size;
  const float wz = (float)bz * s.block_m + ((float)lz + 0.5f) * s.voxel_size;

  const float px = params[0] * wx + params[1] * wy + params[2] * wz + params[3];
  const float py = params[4] * wx + params[5] * wy + params[6] * wz + params[7];
  const float pz = params[8] * wx + params[9] * wy + params[10] * wz + params[11];
  const float fx = params[12], fy = params[13], cx = params[14], cy = params[15];
  const float sign = params[16];

  const bool zok = pz > 1e-6f;
  const float zsafe = zok ? pz : 1.0f;
  const float u = px / zsafe * fx + cx;
  const float vv = py / zsafe * fy + cy;
  const bool in_img = zok && u >= 0.0f && u <= (float)(W - 1) && vv >= 0.0f && vv <= (float)(H - 1);
  const int ui = (int)fminf(fmaxf(u + 0.5f, 0.0f), (float)(W - 1));
  const int vi = (int)fminf(fmaxf(vv + 0.5f, 0.0f), (float)(H - 1));

  const float d = depth[vi * W + ui];
  const int cidx = ((vi / (H / Hc)) * Wc + ui / (W / Wc)) * 3;
  const float cr = (float)color_img[cidx + 0] * s.inv255;
  const float cg = (float)color_img[cidx + 1] * s.inv255;
  const float cb = (float)color_img[cidx + 2] * s.inv255;

  const float trunc = s.trunc_base + s.trunc_scale * d;
  const float sdf_val = d - pz;
  const bool upd_ok = in_img && d > 0.0f && d < s.max_dist && sdf_val > -trunc;
  const float sdf_new = fminf(fmaxf(sdf_val, -trunc), trunc);
  const float dw = upd_ok ? s.w_sample * sign : 0.0f;

  const size_t row = (size_t)slot * kNvox + v;
  const size_t crow = (size_t)slot * (3 * kNvox) + v;
  const float old_w = weight[row];
  const float old_sdf = sdf[row];
  float new_w = old_w + dw;
  const float num = old_sdf * old_w + sdf_new * dw;
  float upd_sdf = new_w > 1e-6f ? num / fmaxf(new_w, 1e-6f) : 0.0f;
  const float col_r = color[crow] + cr * dw;
  const float col_g = color[crow + kNvox] + cg * dw;
  const float col_b = color[crow + 2 * kNvox] + cb * dw;
  new_w = fminf(fmaxf(new_w, 0.0f), s.max_weight);
  const float upd_w = new_w > 1e-6f ? new_w : 0.0f;
  const bool live = upd_w > 0.0f;
  sdf[row] = live ? upd_sdf : 0.0f;
  weight[row] = upd_w;
  color[crow] = live ? col_r : 0.0f;
  color[crow + kNvox] = live ? col_g : 0.0f;
  color[crow + 2 * kNvox] = live ? col_b : 0.0f;
}

}  // namespace

extern "C" int bf_tsdf_integrate(
    float* sdf, float* weight, float* color, const int32_t* key_of_slot,
    const int32_t* slots, const uint8_t* mask, int num_slots, const float* depth,
    int H, int W, const uint8_t* color_img, int Hc, int Wc, const float* params,
    float voxel_size, float block_m, float trunc_base, float trunc_scale,
    float max_dist, float max_weight, float w_sample, float inv255, void* stream) {
  if (num_slots <= 0) return 0;
  FuseScalars s{voxel_size, block_m, trunc_base, trunc_scale,
                max_dist, max_weight, w_sample, inv255};
  tsdf_integrate_kernel<<<num_slots, kNvox, 0, (cudaStream_t)stream>>>(
      sdf, weight, color, key_of_slot, slots, mask, depth, H, W, color_img, Hc, Wc,
      params, s);
  return (int)cudaGetLastError();
}
