// Projective dense verification of frame pairs in one launch: for every
// (pair, direction), the source frame's cached points are moved by the
// pair's transform, projected into the destination frame's cache, sampled
// bilinearly there (depth, normal, intensity), tested, and reduced to four
// numbers: the source's valid pixels, the projected pixels, the agreeing
// pixels and the sum of the projected pixels' depth errors.
//
// Replaces the XLA einsums of bundlefusion_tpu/features/filters.py::
// dense_verify (its tent-weight sampling, ops/preprocess.py::
// bilinear_sample_matmul, and the per-pixel tests and sums around it; no
// Pallas kernel there: the port's own H100 profile put the matmul-form
// sampling at most of graph_step and a fifth of chunk_local). Its plain
// PyTorch twin is bundlefusion_tpu_torch/features/filters.py::
// _dense_verify_torch.
//
// What bounds it on an H100: bytes. Per source pixel it reads its depth
// (4 B), per valid one its point (12 B), per projected one its normal and
// intensity (16 B) and four taps of the destination's five channels, mostly
// from L1/L2 (one destination frame is 96 KB at 80x60); ~130 flops and one
// square root and four divides per projected pixel. Per (pair, direction)
// it writes 16 B.
//
// Design: one CTA of kThreads threads per (pair, direction); thread t takes
// pixels t, t + kThreads, ... in order and keeps its three counts and its
// depth-error sum in registers; an invalid pixel (depth not > 0) reads
// nothing more, and one that cannot project (z <= 1e-6, outside the image)
// reads no taps. The sum is then reduced in
// a fixed order: each warp by shuffles (offsets 16, 8, 4, 2, 1), the
// warps' sums by shuffles in warp 0 (offsets kWarps / 2, ..., 1); the
// counts are integers. No atomics, no shared staging, nothing allocated.
// A side's frames are addressed by a per-pair stride (0 for a frame
// broadcast to every pair), so no copy of an expanded cache is made. The
// arithmetic is the twin's, op by op under --fmad=false: the transform as
// ((r0 * x + r1 * y) + r2 * z) + t, project's z guard and divide, the
// sampling's clamps (NaN passes through), u0 = floor(u) (a NaN gives 0 and
// NaN weights) and tents clamp(1 - |u - u0|, 0) and clamp(1 - |u - (u0 +
// 1)|, 0), contracted along v, then along u, the normal normalised by
// max(sqrt((x * x + y * y) + z * z), 1e-9).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Side {
  const float* depth;    // [pairs, h, w] at pair stride `stride`
  const float* points;   // [pairs, h, w, 3] at pair stride 3 * stride
  const float* normals;  // [pairs, h, w, 3] at pair stride 3 * stride
  const float* inten;    // [pairs, h, w] at pair stride `stride`
  long long stride;      // pixels from one pair's frame to the next (0: one frame for all)
};

struct Params {
  Side a, b;
  const float* T0;  // [pairs, 4, 4]: a -> b
  const float* T1;  // [pairs, 4, 4]: b -> a (direction 1), or null
  float* out;       // [dirs, pairs, 4]
  int pairs, h, w;
  float fx, fy, cx, cy;
  float u_max, v_max;      // project's inside test: u <= width - 1
  float u_inb, v_inb;      // the sampling's in-bounds test: u < w - 1 + 1e-4
  float u_clamp, v_clamp;  // the sampling's clamp: w - 1.001
  float dist_thr, normal_thr, color_thr;
};

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float tent(float l, float at) {
  const float t = 1.0f - fabsf(l - at);
  return isnan(t) ? t : fmaxf(t, 0.0f);
}

// one channel sampled at the four taps from `base` (pixel index of (v0, u0)),
// `step` floats per pixel: along v, then along u
__device__ __forceinline__ float sample(const float* __restrict__ c, int base, int w, int step, float tv0, float tv1,
                                        float tu0, float tu1) {
  const float col0 = tv0 * __ldg(c + (size_t)base * step) + tv1 * __ldg(c + (size_t)(base + w) * step);
  const float col1 = tv0 * __ldg(c + (size_t)(base + 1) * step) + tv1 * __ldg(c + (size_t)(base + w + 1) * step);
  return col0 * tu0 + col1 * tu1;
}

__global__ void __launch_bounds__(kThreads) dense_verify_kernel(const Params prm) {
  const int pair = blockIdx.x;
  const int dir = blockIdx.y;
  const Side src = dir == 0 ? prm.a : prm.b;
  const Side dst = dir == 0 ? prm.b : prm.a;
  const float* __restrict__ T = (dir == 0 ? prm.T0 : prm.T1) + (size_t)pair * 16;
  const float r00 = __ldg(T + 0), r01 = __ldg(T + 1), r02 = __ldg(T + 2), t0 = __ldg(T + 3);
  const float r10 = __ldg(T + 4), r11 = __ldg(T + 5), r12 = __ldg(T + 6), t1 = __ldg(T + 7);
  const float r20 = __ldg(T + 8), r21 = __ldg(T + 9), r22 = __ldg(T + 10), t2 = __ldg(T + 11);

  const int w = prm.w;
  const int d = prm.h * w;
  const size_t so = (size_t)pair * (size_t)src.stride;
  const size_t dof = (size_t)pair * (size_t)dst.stride;
  const float* __restrict__ sd = src.depth + so;
  const float* __restrict__ sp = src.points + 3 * so;
  const float* __restrict__ sn = src.normals + 3 * so;
  const float* __restrict__ si = src.inten + so;
  const float* __restrict__ bd = dst.depth + dof;
  const float* __restrict__ bn = dst.normals + 3 * dof;
  const float* __restrict__ bi = dst.inten + dof;

  int n_valid = 0, n_proj = 0, n_agree = 0;
  float acc = 0.0f;
  for (int p = threadIdx.x; p < d; p += kThreads) {
    if (!(__ldg(sd + p) > 0.0f)) continue;  // an invalid pixel reads no point and no taps
    n_valid += 1;
    const float px = __ldg(sp + 3 * p), py = __ldg(sp + 3 * p + 1), pz = __ldg(sp + 3 * p + 2);
    const float x = ((r00 * px + r01 * py) + r02 * pz) + t0;
    const float y = ((r10 * px + r11 * py) + r12 * pz) + t1;
    const float z = ((r20 * px + r21 * py) + r22 * pz) + t2;
    const bool zok = z > (float)1e-6;
    const float zs = zok ? z : 1.0f;
    const float u = x / zs * prm.fx + prm.cx;
    const float v = y / zs * prm.fy + prm.cy;
    const bool inside = (u >= 0.0f) & (u <= prm.u_max) & (v >= 0.0f) & (v <= prm.v_max);
    const bool inb = (u >= 0.0f) & (u < prm.u_inb) & (v >= 0.0f) & (v < prm.v_inb);
    if (!(zok & inside & inb)) continue;  // proj_ok is false whatever the taps hold

    const float uc = clamp_nan(u, 0.0f, prm.u_clamp), vc = clamp_nan(v, 0.0f, prm.v_clamp);
    const float u0 = floorf(uc), v0 = floorf(vc);  // in range: u and v passed the in-bounds test
    const float tv0 = tent(vc, v0), tv1 = tent(vc, v0 + 1.0f);
    const float tu0 = tent(uc, u0), tu1 = tent(uc, u0 + 1.0f);
    const int base = (int)v0 * w + (int)u0;
    const float depth_b = sample(bd, base, w, 1, tv0, tv1, tu0, tu1);
    if (!(depth_b > 0.0f)) continue;
    n_proj += 1;
    const float dist = fabsf(z - depth_b);
    acc += dist;

    const float nb0 = sample(bn, base, w, 3, tv0, tv1, tu0, tu1);
    const float nb1 = sample(bn + 1, base, w, 3, tv0, tv1, tu0, tu1);
    const float nb2 = sample(bn + 2, base, w, 3, tv0, tv1, tu0, tu1);
    const float inten_b = sample(bi, base, w, 1, tv0, tv1, tu0, tu1);
    const float nx = __ldg(sn + 3 * p), ny = __ldg(sn + 3 * p + 1), nz = __ldg(sn + 3 * p + 2);
    const float na0 = (r00 * nx + r01 * ny) + r02 * nz;
    const float na1 = (r10 * nx + r11 * ny) + r12 * nz;
    const float na2 = (r20 * nx + r21 * ny) + r22 * nz;
    float nrm = sqrtf((nb0 * nb0 + nb1 * nb1) + nb2 * nb2);
    nrm = isnan(nrm) ? nrm : fmaxf(nrm, (float)1e-9);
    const float ndot = (na0 * (nb0 / nrm) + na1 * (nb1 / nrm)) + na2 * (nb2 / nrm);
    const float dint = fabsf(__ldg(si + p) - inten_b);
    n_agree += (dist < prm.dist_thr) & (ndot > prm.normal_thr) & (dint < prm.color_thr);
  }

  // the fixed-order reduction: each warp, then the warps in warp 0
  __shared__ float s_acc[kWarps];
  __shared__ int s_cnt[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  n_valid = __reduce_add_sync(kFull, n_valid);
  n_proj = __reduce_add_sync(kFull, n_proj);
  n_agree = __reduce_add_sync(kFull, n_agree);
  if (lane == 0) {
    s_acc[warp] = acc;
    s_cnt[0][warp] = n_valid;
    s_cnt[1][warp] = n_proj;
    s_cnt[2][warp] = n_agree;
  }
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? s_acc[lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    const int cv = __reduce_add_sync(kFull, lane < kWarps ? s_cnt[0][lane] : 0);
    const int cp = __reduce_add_sync(kFull, lane < kWarps ? s_cnt[1][lane] : 0);
    const int ca = __reduce_add_sync(kFull, lane < kWarps ? s_cnt[2][lane] : 0);
    if (lane == 0) {
      float* o = prm.out + ((size_t)dir * prm.pairs + pair) * 4;
      o[0] = (float)cv;
      o[1] = (float)cp;
      o[2] = (float)ca;
      o[3] = v;
    }
  }
}

}  // namespace

extern "C" int bf_dense_verify(const float* a_depth, const float* a_points, const float* a_normals,
                               const float* a_inten, long long a_stride, const float* b_depth, const float* b_points,
                               const float* b_normals, const float* b_inten, long long b_stride, const float* T0,
                               const float* T1, float* out, int pairs, int dirs, int h, int w, float fx, float fy,
                               float cx, float cy, float u_max, float v_max, float u_inb, float v_inb, float u_clamp,
                               float v_clamp, float dist_thr, float normal_thr, float color_thr, void* stream) {
  if (pairs == 0) return 0;
  if (dirs < 1 || dirs > 2 || (dirs == 2 && T1 == nullptr) || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  Params prm;
  prm.a = Side{a_depth, a_points, a_normals, a_inten, a_stride};
  prm.b = Side{b_depth, b_points, b_normals, b_inten, b_stride};
  prm.T0 = T0;
  prm.T1 = T1;
  prm.out = out;
  prm.pairs = pairs;
  prm.h = h;
  prm.w = w;
  prm.fx = fx;
  prm.fy = fy;
  prm.cx = cx;
  prm.cy = cy;
  prm.u_max = u_max;
  prm.v_max = v_max;
  prm.u_inb = u_inb;
  prm.v_inb = v_inb;
  prm.u_clamp = u_clamp;
  prm.v_clamp = v_clamp;
  prm.dist_thr = dist_thr;
  prm.normal_thr = normal_thr;
  prm.color_thr = color_thr;
  dense_verify_kernel<<<dim3((unsigned)pairs, (unsigned)dirs), kThreads, 0, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
