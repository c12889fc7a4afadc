// Fused depth preprocessing in one launch: zero-aware bilateral filter ->
// unprojection -> normals, for a batch of frames [N, H, W]; the point and
// normal maps are optional.
//
// Replaces the Pallas TPU kernel bundlefusion_tpu/ops/pallas_kernels.py::
// _preprocess_kernel (entry point fused_preprocess_pallas). Its plain
// PyTorch twin is bundlefusion_tpu_torch/ops/preprocess.py::
// _preprocess_chain_torch.
//
// What bounds it on an H100: the bilateral window's arithmetic. Each pixel
// evaluates 49 range weights (an IEEE expf each: one MUFU ex2 and 7 other
// instructions) and ~10 more instructions per tap, against 4 bytes read
// and 4 (fdepth only) or 28 bytes written: compute bound, and in practice
// bound by instruction issue (~18 per tap), not by the MUFU unit.
//
// Design:
//   * 2-D tiles, one CTA of 32x16 threads each. The tile's raw depth plus a
//     halo of the radius is loaded once into shared memory by coalesced
//     loads, zero-padded at the image edge as _shift2d pads. Every tap then
//     reads shared memory.
//   * the (2r+1)^2 spatial weights come from a table that each CTA fills
//     once with the twin's expression expf(-(dy*dy+dx*dx)*inv_2sd2): the
//     expf count per pixel halves, and the weights stay bit-equal.
//   * accumulation in the twin's order: neighbour (y - dy, x - dx), dy then
//     dx, then acc / max(wacc, 1e-8). Radius 0 is the identity filter.
//   * the taps are branch-free: an invalid neighbour's weight is zeroed by
//     a multiply, so the compiler does not wrap each expf in a branch.
//   * geometry on: the threads filter the tile plus a one-pixel ring (the
//     output tile is 30x14), keep the filtered depth in shared memory, and
//     the inner threads form points and normals from it in the same launch:
//     a neighbour's point is recomputed with the same (x - cx) / fx * fd
//     arithmetic, so nothing is written and read back. Normals are
//     cross(dy, dx) scaled by 1 / max(|n|, 1e-9) and flipped to nz <= 0.
//   * geometry off (the main path, which reads only the filtered depth):
//     32x16 output pixels per CTA, no ring, and fdepth is the only output.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32, kBY = 16;  // threads per CTA: one warp per tile row

template <int kR, bool kGeom>
__global__ void __launch_bounds__(kBX * kBY) preprocess_kernel(
    const float* __restrict__ depth, float* __restrict__ fdepth, float* __restrict__ points,
    float* __restrict__ normals, int H, int W, float fx, float fy, float cx, float cy,
    float inv_2sd2, float inv_2sr2) {
  constexpr int kG = kGeom ? 1 : 0;  // ring of filtered pixels the normals need
  constexpr int kTX = kBX - 2 * kG, kTY = kBY - 2 * kG;  // output tile
  constexpr int kSX = kBX + 2 * kR, kSY = kBY + 2 * kR;  // raw tile with halo
  constexpr int kTaps = (2 * kR + 1) * (2 * kR + 1);
  __shared__ float raw[kSY][kSX];
  __shared__ float wsp[kTaps];
  __shared__ float filt[kBY][kBX];  // filtered depth (geometry only)

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const float* img = depth + frame;
  // image coordinates of thread (0, 0), and of the raw tile's corner
  const int x0 = blockIdx.x * kTX - kG, y0 = blockIdx.y * kTY - kG;
  for (int i = tid; i < kSX * kSY; i += kBX * kBY) {
    const int gy = y0 - kR + i / kSX, gx = x0 - kR + i % kSX;
    raw[i / kSX][i % kSX] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
  }
  if (tid < kTaps) {
    const int dy = tid / (2 * kR + 1) - kR, dx = tid % (2 * kR + 1) - kR;
    wsp[tid] = expf(-(float)(dy * dy + dx * dx) * inv_2sd2);
  }
  __syncthreads();

  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x >= 0 && x < W && y >= 0 && y < H;
  const float c = raw[ty + kR][tx + kR];
  const bool valid = c > 0.0f;
  float acc = 0.0f, wacc = 0.0f;
  if (valid) {  // an invalid centre gets no weight at all
#pragma unroll
    for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll
      for (int dx = -kR; dx <= kR; ++dx) {
        const float dn = raw[ty + kR - dy][tx + kR - dx];
        const float ws = wsp[(dy + kR) * (2 * kR + 1) + (dx + kR)];
        const float diff = dn - c;
        // weight 0 for an invalid neighbour, as a multiply by 0 (ws * e is
        // finite and >= 0, so the product is exactly the twin's 0): a
        // branch around the expf would cost more than the expf
        const float wgt = ws * expf(-(diff * diff) * inv_2sr2) * (float)(dn > 0.0f);
        acc += wgt * dn;
        wacc += wgt;
      }
    }
  }
  const float fd = (inside && valid && wacc > 1e-8f) ? acc / fmaxf(wacc, 1e-8f) : 0.0f;

  if (!kGeom) {
    if (inside) fdepth[frame + (size_t)y * W + x] = fd;
    return;
  }
  filt[ty][tx] = fd;  // 0 outside the image: a zero-padded neighbour
  __syncthreads();
  if (!inside || tx < kG || tx >= kBX - kG || ty < kG || ty >= kBY - kG) return;

  const size_t idx = frame + (size_t)y * W + x;
  fdepth[idx] = fd;
  const bool ok = fd > 0.0f;
  points[idx * 3 + 0] = ok ? ((float)x - cx) / fx * fd : 0.0f;
  points[idx * 3 + 1] = ok ? ((float)y - cy) / fy * fd : 0.0f;
  points[idx * 3 + 2] = fd;

  // the 4-neighbours' points, recomputed from their filtered depth
  const float zr = filt[ty][tx + 1], zl = filt[ty][tx - 1];
  const float zd = filt[ty + 1][tx], zu = filt[ty - 1][tx];
  const float pr[3] = {zr > 0.0f ? ((float)(x + 1) - cx) / fx * zr : 0.0f,
                       zr > 0.0f ? ((float)y - cy) / fy * zr : 0.0f, zr};
  const float pl[3] = {zl > 0.0f ? ((float)(x - 1) - cx) / fx * zl : 0.0f,
                       zl > 0.0f ? ((float)y - cy) / fy * zl : 0.0f, zl};
  const float pd[3] = {zd > 0.0f ? ((float)x - cx) / fx * zd : 0.0f,
                       zd > 0.0f ? ((float)(y + 1) - cy) / fy * zd : 0.0f, zd};
  const float pu[3] = {zu > 0.0f ? ((float)x - cx) / fx * zu : 0.0f,
                       zu > 0.0f ? ((float)(y - 1) - cy) / fy * zu : 0.0f, zu};
  const float ax = pr[0] - pl[0], ay = pd[0] - pu[0];
  const float bx = pr[1] - pl[1], by = pd[1] - pu[1];
  const float cxn = pr[2] - pl[2], cyn = pd[2] - pu[2];
  float nx = by * cxn - cyn * bx;
  float ny = cyn * ax - ay * cxn;
  float nz = ay * bx - by * ax;
  const float nrm = sqrtf(nx * nx + ny * ny + nz * nz);
  const bool nvalid = zr > 0.0f && zl > 0.0f && zu > 0.0f && zd > 0.0f && nrm > 1e-9f;
  const float inv = nvalid ? 1.0f / fmaxf(nrm, 1e-9f) : 0.0f;
  nx = nx * inv;
  ny = ny * inv;
  nz = nz * inv;
  const float flip = nz > 0.0f ? -1.0f : 1.0f;
  normals[idx * 3 + 0] = nx * flip;
  normals[idx * 3 + 1] = ny * flip;
  normals[idx * 3 + 2] = nz * flip;
}

template <int kR>
int launch(const float* depth, float* fdepth, float* points, float* normals, int N, int H, int W,
           float fx, float fy, float cx, float cy, float inv_2sd2, float inv_2sr2, cudaStream_t st) {
  const dim3 block(kBX, kBY);
  if (points != nullptr) {
    const dim3 grid((W + kBX - 3) / (kBX - 2), (H + kBY - 3) / (kBY - 2), N);
    preprocess_kernel<kR, true><<<grid, block, 0, st>>>(depth, fdepth, points, normals, H, W, fx,
                                                        fy, cx, cy, inv_2sd2, inv_2sr2);
  } else {
    const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, N);
    preprocess_kernel<kR, false><<<grid, block, 0, st>>>(depth, fdepth, nullptr, nullptr, H, W, fx,
                                                         fy, cx, cy, inv_2sd2, inv_2sr2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// points == normals == nullptr: filtered depth only. radius in [0, 3].
extern "C" int bf_preprocess(const float* depth, float* fdepth, float* points, float* normals,
                             int N, int H, int W, float fx, float fy, float cx, float cy,
                             float inv_2sd2, float inv_2sr2, int radius, void* stream) {
  if ((long long)N * H * W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (radius) {
    case 0: return launch<0>(depth, fdepth, points, normals, N, H, W, fx, fy, cx, cy, inv_2sd2, inv_2sr2, st);
    case 1: return launch<1>(depth, fdepth, points, normals, N, H, W, fx, fy, cx, cy, inv_2sd2, inv_2sr2, st);
    case 2: return launch<2>(depth, fdepth, points, normals, N, H, W, fx, fy, cx, cy, inv_2sd2, inv_2sr2, st);
    case 3: return launch<3>(depth, fdepth, points, normals, N, H, W, fx, fy, cx, cy, inv_2sd2, inv_2sr2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
