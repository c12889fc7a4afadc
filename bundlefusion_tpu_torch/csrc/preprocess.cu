// Fused depth preprocessing: zero-aware bilateral filter -> unprojection ->
// normals, for a batch of frames [N, H, W].
//
// Replaces the Pallas TPU kernel bundlefusion_tpu/ops/pallas_kernels.py::
// _preprocess_kernel (entry point fused_preprocess_pallas). Its plain
// PyTorch twin is bundlefusion_tpu_torch/ops/preprocess.py::
// _preprocess_chain_torch.
//
// What bounds it on an H100: the bilateral window. Each pixel reads 49
// neighbours and evaluates 49 expf range weights, ~600 flops against 4 bytes
// read and 28 bytes written, so it is compute (SFU exp) bound rather than
// bound by device memory; the neighbour reads hit L1/L2. 11 frames at
// 640x480 are 3.4 M threads, enough to fill every SM.
//
// Design:
//   * launch 1, one thread per pixel: the 7x7 window straight from global
//     memory (a shared-memory tile is a later optimisation), then
//     unprojection; writes the filtered depth and the point map.
//   * launch 2, one thread per pixel: normals from the central differences
//     of the 4-neighbours' points. It needs its neighbours' filtered depth,
//     which only exists once launch 1 has finished: hence two launches.
//   * the operation order is the TPU kernel's: weights
//     exp(-(dy^2+dx^2)*inv_2sd2) * exp(-diff^2*inv_2sr2), accumulated over
//     dy then dx, then acc / max(wacc, 1e-8); normals cross(dy, dx) scaled by
//     1 / max(|n|, 1e-9) and flipped to nz <= 0.
//   * radius 0 is the identity filter (weight 1 on the centre pixel only):
//     the unfiltered configuration runs the same kernels.

#include <cuda_runtime.h>

namespace {

__global__ void bilateral_unproject_kernel(
    const float* __restrict__ depth, float* __restrict__ fdepth, float* __restrict__ points,
    int N, int H, int W, float fx, float fy, float cx, float cy, float inv_2sd2,
    float inv_2sr2, int radius) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)N * H * W;
  if (idx >= total) return;
  const int x = (int)(idx % W);
  const int y = (int)((idx / W) % H);
  const float* img = depth + (idx - (long long)y * W - x);  // this frame's [H, W]

  const float c = depth[idx];
  const bool valid = c > 0.0f;
  float acc = 0.0f, wacc = 0.0f;
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx) {
      // zero-padded shift: the neighbour at (y - dy, x - dx)
      const int yy = y - dy, xx = x - dx;
      const float dn = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? img[yy * W + xx] : 0.0f;
      const float ws = expf(-(float)(dy * dy + dx * dx) * inv_2sd2);
      const float diff = dn - c;
      const float wgt = (dn > 0.0f && valid) ? ws * expf(-(diff * diff) * inv_2sr2) : 0.0f;
      acc += wgt * dn;
      wacc += wgt;
    }
  }
  const float fd = (valid && wacc > 1e-8f) ? acc / fmaxf(wacc, 1e-8f) : 0.0f;
  fdepth[idx] = fd;
  const bool ok = fd > 0.0f;
  points[idx * 3 + 0] = ok ? ((float)x - cx) / fx * fd : 0.0f;
  points[idx * 3 + 1] = ok ? ((float)y - cy) / fy * fd : 0.0f;
  points[idx * 3 + 2] = fd;
}

__global__ void normals_kernel(const float* __restrict__ points, float* __restrict__ normals,
                               int N, int H, int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)N * H * W;
  if (idx >= total) return;
  const int x = (int)(idx % W);
  const int y = (int)((idx / W) % H);
  const bool has_r = x + 1 < W, has_l = x > 0, has_d = y + 1 < H, has_u = y > 0;
  const float* pr = points + (idx + 1) * 3;
  const float* pl = points + (idx - 1) * 3;
  const float* pd = points + (idx + W) * 3;
  const float* pu = points + (idx - W) * 3;
  float dxc[3], dyc[3];
  for (int k = 0; k < 3; ++k) {
    dxc[k] = (has_r ? pr[k] : 0.0f) - (has_l ? pl[k] : 0.0f);
    dyc[k] = (has_d ? pd[k] : 0.0f) - (has_u ? pu[k] : 0.0f);
  }
  const float ax = dxc[0], ay = dyc[0];
  const float bx = dxc[1], by = dyc[1];
  const float cx = dxc[2], cy = dyc[2];
  float nx = by * cx - cy * bx;
  float ny = cy * ax - ay * cx;
  float nz = ay * bx - by * ax;
  const float nrm = sqrtf(nx * nx + ny * ny + nz * nz);
  const bool nvalid = (has_r && pr[2] > 0.0f) && (has_l && pl[2] > 0.0f) &&
                      (has_u && pu[2] > 0.0f) && (has_d && pd[2] > 0.0f) && nrm > 1e-9f;
  const float inv = nvalid ? 1.0f / fmaxf(nrm, 1e-9f) : 0.0f;
  nx = nx * inv;
  ny = ny * inv;
  nz = nz * inv;
  const float flip = nz > 0.0f ? -1.0f : 1.0f;
  normals[idx * 3 + 0] = nx * flip;
  normals[idx * 3 + 1] = ny * flip;
  normals[idx * 3 + 2] = nz * flip;
}

}  // namespace

extern "C" int bf_preprocess(const float* depth, float* fdepth, float* points, float* normals,
                             int N, int H, int W, float fx, float fy, float cx, float cy,
                             float inv_2sd2, float inv_2sr2, int radius, void* stream) {
  const long long total = (long long)N * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  bilateral_unproject_kernel<<<blocks, threads, 0, st>>>(depth, fdepth, points, N, H, W, fx, fy,
                                                         cx, cy, inv_2sd2, inv_2sr2, radius);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normals_kernel<<<blocks, threads, 0, st>>>(points, normals, N, H, W);
  return (int)cudaGetLastError();
}
