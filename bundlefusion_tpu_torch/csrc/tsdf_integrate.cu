// TSDF integrate / exact de-integrate of R update rows of 8^3 blocks in one
// launch (a whole fuse_batch: de-integrations first, then integrations).
//
// Replaces the Pallas TPU kernel bundlefusion_tpu/fusion/pallas_tsdf.py::_kernel
// (entry point integrate_blocks_pallas_planar, scanned over the rows by
// bundlefusion_tpu/fusion/tsdf.py). Its plain PyTorch twin is
// bundlefusion_tpu_torch/fusion/tsdf.py::_integrate_rows_torch, the
// single-row update applied row by row.
//
// What bounds it on an H100: on paper, device memory and the per-voxel
// arithmetic by about the same margin (~40 us at the flagship fuse). A
// block's sdf, weight and colour rows are 20 KB, and consecutive frames of a
// chunk see mostly the same blocks (~3,600 live slots per row of a flagship
// fuse of 31 rows, ~4,500 blocks in the union), so a kernel per row moved
// each block's 20 KB about 25 times each way; here each block is read once
// and written once, and the rows' depth and colour frames (1.46 MB each at
// 640x480) stay in the 50 MB L2. In practice it is bound by instruction
// issue: one row's update of one voxel is ~42 flops, but three IEEE divides
// and no contracted multiply-adds (--fmad=false keeps the twin's rounding)
// make it ~130 instructions.
//
// Design:
//   * the work list comes from PyTorch (fusion/tsdf.py::fuse_worklist): the
//     sorted union of the rows' applied keys, padded with INVALID_KEY. A
//     persistent grid walks it and stops at the first padding entry, so the
//     host never reads how long it is (no sync) and the grid does not scale
//     with the padded length.
//   * per entry, thread r binary-searches row r's sorted key list for the
//     entry's key; the row applies the entry where the key is there and
//     its mask is set. The positions sit in shared memory with the rows'
//     params [R x 17] and frame indices.
//   * one CTA per entry at a time; each thread owns kVox consecutive voxels
//     of one x-run of the planar pools, loaded once as one vector from sdf,
//     weight and each colour plane.
//   * the CTA applies every row in order; a row that does not apply the
//     entry is skipped uniformly. A row projects with its own params and
//     gathers its own frame.
//   * one store per voxel at the end. A slot belongs to one union entry,
//     hence to one CTA: no atomics.
//   * each voxel sees the twin's arithmetic in the twin's order, and the
//     build uses --fmad=false: weights stay bit-equal to the twin, and an
//     integrate followed by a de-integrate restores them exactly.
//   * depth (f32 [H, W]) and the reduced-resolution uint8 colour
//     ([H >> sy, W >> sx, 3]) are sampled directly at the nearest pixel
//     floor(u + 0.5): no sampling window, so no voxel is ever dropped for
//     lying outside one.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kNvox = 512;
constexpr int kOff = 512;            // fusion/blocks.py _OFF
constexpr int kInvalidKey = 1 << 30;  // fusion/blocks.py INVALID_KEY
constexpr int kParams = 17;  // w2c 3x4, fx, fy, cx, cy, sign
constexpr int kVox = 4;      // voxels per thread: one float4 of a planar pool row
constexpr int kThreads = kNvox / kVox;

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

struct Rows {  // the [R, cap] row lists, each with its row stride
  const int32_t* keys;
  const int32_t* slots;
  const bool* masks;
  long long key_stride, slot_stride, mask_stride;
  int cap;
};

struct Voxel {
  float sdf, w, r, g, b;
};

// One row's update of the thread's kVox voxels, centred at (wx[i], wy, wz):
// the twin's arithmetic, op by op, in three stages over the voxels
// (project, gather, update) so that the kVox gathers are in flight at once.
__device__ __forceinline__ void update_row(Voxel (&s)[kVox], const float (&wx)[kVox], float wy,
                                           float wz, const float* __restrict__ P,
                                           const float* __restrict__ depth, int H, int W,
                                           const uchar4* __restrict__ cimg, int Wc, int sy, int sx,
                                           const FuseScalars& k) {
  float pz[kVox];
  bool in_img[kVox];
  int ui[kVox], vi[kVox];
#pragma unroll
  for (int i = 0; i < kVox; ++i) {
    const float px = P[0] * wx[i] + P[1] * wy + P[2] * wz + P[3];
    const float py = P[4] * wx[i] + P[5] * wy + P[6] * wz + P[7];
    pz[i] = P[8] * wx[i] + P[9] * wy + P[10] * wz + P[11];
    const bool zok = pz[i] > 1e-6f;
    const float zsafe = zok ? pz[i] : 1.0f;
    const float u = px / zsafe * P[12] + P[14];
    const float v = py / zsafe * P[13] + P[15];
    in_img[i] = zok && u >= 0.0f && u <= (float)(W - 1) && v >= 0.0f && v <= (float)(H - 1);
    ui[i] = (int)fminf(fmaxf(u + 0.5f, 0.0f), (float)(W - 1));
    vi[i] = (int)fminf(fmaxf(v + 0.5f, 0.0f), (float)(H - 1));
  }
  float d[kVox];
  uchar4 c[kVox];
#pragma unroll
  for (int i = 0; i < kVox; ++i) {
    d[i] = depth[vi[i] * W + ui[i]];
    c[i] = cimg[(vi[i] >> sy) * Wc + (ui[i] >> sx)];
  }
#pragma unroll
  for (int i = 0; i < kVox; ++i) {
    const float cr = (float)c[i].x * k.inv255;
    const float cg = (float)c[i].y * k.inv255;
    const float cb = (float)c[i].z * k.inv255;
    const float trunc = k.trunc_base + k.trunc_scale * d[i];
    const float sdf_val = d[i] - pz[i];
    const bool upd_ok = in_img[i] && d[i] > 0.0f && d[i] < k.max_dist && sdf_val > -trunc;
    const float sdf_new = fminf(fmaxf(sdf_val, -trunc), trunc);
    const float dw = upd_ok ? k.w_sample * P[16] : 0.0f;

    float new_w = s[i].w + dw;
    const float num = s[i].sdf * s[i].w + sdf_new * dw;
    const float upd_sdf = new_w > 1e-6f ? num / fmaxf(new_w, 1e-6f) : 0.0f;
    const float col_r = s[i].r + cr * dw;
    const float col_g = s[i].g + cg * dw;
    const float col_b = s[i].b + cb * dw;
    new_w = fminf(fmaxf(new_w, 0.0f), k.max_weight);
    const float upd_w = new_w > 1e-6f ? new_w : 0.0f;
    const bool live = upd_w > 0.0f;
    s[i].sdf = live ? upd_sdf : 0.0f;
    s[i].w = upd_w;
    s[i].r = live ? col_r : 0.0f;
    s[i].g = live ? col_g : 0.0f;
    s[i].b = live ? col_b : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) tsdf_fuse_kernel(
    float* __restrict__ sdf, float* __restrict__ weight, float* __restrict__ color,
    const int32_t* __restrict__ union_keys, int max_entries, Rows rows, int R,
    const float* __restrict__ depths, int H, int W, const uchar4* __restrict__ colors, int sy,
    int sx, const int64_t* __restrict__ fidx, const float* __restrict__ params, FuseScalars k) {
  extern __shared__ float smem[];
  float* P_s = smem;                                                // [R * 17] row params
  int64_t* frame_s = (int64_t*)(smem + ((R * kParams + 1) & ~1));  // [R] frame index
  int* pos_s = (int*)(frame_s + R);                                 // [R] entry's position per row
  __shared__ int slot_s;
  const int t = threadIdx.x;
  for (int i = t; i < R * kParams; i += kThreads) P_s[i] = params[i];
  for (int i = t; i < R; i += kThreads) frame_s[i] = fidx[i];

  const int v0 = t * kVox;
  const int lx0 = v0 & 7, ly = (v0 >> 3) & 7, lz = v0 >> 6;
  const int Wc = W >> sx;
  const size_t hw = (size_t)H * W, chw = (size_t)(H >> sy) * Wc;

  for (int e = blockIdx.x; e < max_entries; e += gridDim.x) {
    const int key = union_keys[e];
    if (key == kInvalidKey) break;  // sorted: padding only from here on
    __syncthreads();  // the previous entry's rows are done with pos_s
    for (int r = t; r < R; r += kThreads) {
      const int32_t* kr = rows.keys + r * rows.key_stride;
      int lo = 0, hi = rows.cap;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kr[mid] < key) lo = mid + 1; else hi = mid;
      }
      const bool hit = lo < rows.cap && kr[lo] == key && rows.masks[r * rows.mask_stride + lo];
      pos_s[r] = hit ? lo : -1;
      if (hit) slot_s = rows.slots[r * rows.slot_stride + lo];  // every hit names the same slot
    }
    __syncthreads();

    const int slot = slot_s;
    const int bx = (key & 1023) - kOff;
    const int by = ((key >> 10) & 1023) - kOff;
    const int bz = ((key >> 20) & 1023) - kOff;
    // voxel centre: block origin + (l + 0.5) * voxel (blocks.voxel_centers)
    float wx[kVox];
#pragma unroll
    for (int i = 0; i < kVox; ++i)
      wx[i] = (float)bx * k.block_m + ((float)(lx0 + i) + 0.5f) * k.voxel_size;
    const float wy = (float)by * k.block_m + ((float)ly + 0.5f) * k.voxel_size;
    const float wz = (float)bz * k.block_m + ((float)lz + 0.5f) * k.voxel_size;

    const size_t row = (size_t)slot * kNvox + v0;
    const size_t crow = (size_t)slot * (3 * kNvox) + v0;
    const float4 s4 = *reinterpret_cast<const float4*>(sdf + row);
    const float4 w4 = *reinterpret_cast<const float4*>(weight + row);
    const float4 r4 = *reinterpret_cast<const float4*>(color + crow);
    const float4 g4 = *reinterpret_cast<const float4*>(color + crow + kNvox);
    const float4 b4 = *reinterpret_cast<const float4*>(color + crow + 2 * kNvox);
    Voxel vox[kVox] = {{s4.x, w4.x, r4.x, g4.x, b4.x},
                       {s4.y, w4.y, r4.y, g4.y, b4.y},
                       {s4.z, w4.z, r4.z, g4.z, b4.z},
                       {s4.w, w4.w, r4.w, g4.w, b4.w}};

    for (int r = 0; r < R; ++r) {
      if (pos_s[r] < 0) continue;  // uniform over the CTA
      const float* P = P_s + r * kParams;
      const float* depth = depths + frame_s[r] * hw;
      const uchar4* cimg = colors + frame_s[r] * chw;
      update_row(vox, wx, wy, wz, P, depth, H, W, cimg, Wc, sy, sx, k);
    }

    *reinterpret_cast<float4*>(sdf + row) = make_float4(vox[0].sdf, vox[1].sdf, vox[2].sdf, vox[3].sdf);
    *reinterpret_cast<float4*>(weight + row) = make_float4(vox[0].w, vox[1].w, vox[2].w, vox[3].w);
    *reinterpret_cast<float4*>(color + crow) = make_float4(vox[0].r, vox[1].r, vox[2].r, vox[3].r);
    *reinterpret_cast<float4*>(color + crow + kNvox) = make_float4(vox[0].g, vox[1].g, vox[2].g, vox[3].g);
    *reinterpret_cast<float4*>(color + crow + 2 * kNvox) = make_float4(vox[0].b, vox[1].b, vox[2].b, vox[3].b);
  }
}

}  // namespace

// Apply R rows to the entries of a sorted, INVALID_KEY-padded union of
// max_entries keys. Each row's key list is sorted ascending; sy and sx are
// the log2 of the depth-to-colour resolution ratios; the colour frames are
// RGBA (the 4th byte unused), so a sample is one 4-byte load.
extern "C" int bf_tsdf_fuse(
    float* sdf, float* weight, float* color, const int32_t* union_keys, int max_entries,
    const int32_t* keys, long long key_stride, const int32_t* slots, long long slot_stride,
    const bool* masks, long long mask_stride, int cap, int R, const float* depths, int H, int W,
    const uchar4* colors, int sy, int sx, const int64_t* fidx, const float* params,
    float voxel_size, float block_m, float trunc_base, float trunc_scale, float max_dist,
    float max_weight, float w_sample, float inv255, void* stream) {
  if (max_entries <= 0 || R <= 0) return 0;
  const size_t smem = (size_t)((R * kParams + 1) & ~1) * sizeof(float) + (size_t)R * sizeof(int64_t) +
                      (size_t)R * sizeof(int);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tsdf_fuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  // a persistent grid: one wave of resident CTAs, or fewer for a short list.
  // The wave is asked once per device and shared-memory size, not at every
  // launch (the launches inside a CUDA graph capture query nothing).
  static std::mutex waves_lock;
  static std::map<std::pair<int, size_t>, long long> waves;
  long long wave = 0;
  {
    std::lock_guard<std::mutex> hold(waves_lock);
    const auto found = waves.find({device, smem});
    if (found != waves.end()) wave = found->second;
  }
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tsdf_fuse_kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
    std::lock_guard<std::mutex> hold(waves_lock);
    waves[{device, smem}] = wave;
  }
  long long grid = wave;
  if (grid > max_entries) grid = max_entries;
  const Rows rows{keys, slots, masks, key_stride, slot_stride, mask_stride, cap};
  const FuseScalars k{voxel_size, block_m, trunc_base, trunc_scale, max_dist, max_weight, w_sample, inv255};
  tsdf_fuse_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      sdf, weight, color, union_keys, max_entries, rows, R, depths, H, W, colors, sy, sx, fidx,
      params, k);
  return (int)cudaGetLastError();
}
