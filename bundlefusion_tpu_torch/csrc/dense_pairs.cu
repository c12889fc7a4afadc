// The dense pair term of bundle adjustment in one launch (and a short
// finishing launch): for every slot of a dense-pair list, a's cached pixels
// are moved into keyframe b by the two poses, projected into b's frame
// cache, sampled bilinearly there (depth, normal, point, intensity,
// gradient), tested, and reduced to the pair's normal-equation blocks: the
// 12x12 JtJ, the 12-vector Jtr, and the counts and squared-residual sums of
// the depth (point-to-plane) and colour (photometric) associations.
//
// Replaces the XLA einsums of bundlefusion_tpu/solver/residuals.py::
// dense_pair_blocks (its _dense_pair_system: every slot's caches gathered,
// b's channels concatenated, [P, M, 12] Jacobians contracted per pixel; no
// Pallas kernel there). The port ran the same einsums on the card, where
// cuBLAS made them millions of tiny products over every slot, live or not.
// Its plain PyTorch twin is bundlefusion_tpu_torch/solver/residuals.py::
// _dense_pair_blocks_torch.
//
// What bounds it on an H100: operations. Per valid pixel of a it reads its
// depth, point and normal (28 B) and, where it projects, four taps of b's
// ten channels, mostly from L1/L2 (one frame is 192 KB at 80x60); ~150
// flops reach the association tests and ~250 more accumulate an associated
// pixel. Per live pair it writes 156 floats.
//
// Design. Both Jacobian rows have the form [p x v, v] for a's world point
// p: v = n_w for the depth row, v = -R_b (g^T dpi/dh) for the colour row,
// and b's half of each row is a's half negated (the depth row's b half,
// n x (p - q) - q x n, is -(p x n)). So a pair's blocks follow from one
// symmetric 6x6 H and one 6-vector g: JtJ = [[H, -H], [-H, H]], Jtr =
// [g, -g]. As in the einsum form, the depth and the colour terms are summed
// apart and added at the end: each thread keeps 21 + 6 sums of each, two
// squared-residual sums and two counts in registers. Work items are (pair,
// split): split s of a pair takes the pixel rows [s * rows, (s + 1) * rows)
// of kThreads pixels each (pixel m = (s * rows + r) * kThreads + t for
// thread t), so that a few pairs still fill the card; CTAs walk the items
// in a grid-stride loop, and an item whose pair is not live costs one load.
// A pixel without depth in a reads nothing more; one that cannot project
// (z <= 1e-6, outside the image) reads no taps; each failed test stops the
// pixel. A thread adds its rows' terms in order. The item's sums are
// reduced in a fixed order: each warp by shuffles (offsets 16, ..., 1),
// then the warps' sums halved in turn by one thread per sum (offsets
// kWarps / 2, ..., 1), into a partial per item. The finishing kernel sums
// each live pair's partials in split order, adds the colour sums to the
// depth sums, and writes the blocks with their signs, and zeros for every
// other slot. No atomics, nothing allocated. The arithmetic is the twin's
// op by op under --fmad=false: transforms as ((r0 * x + r1 * y) + r2 * z) +
// t, project's z guard and divide, bilinear_sample_gather's clamp, floor
// and tents (contracted along v, then along u), lengths as sqrt((x * x + y
// * y) + z * z), a weighted term as (w * J_i) * J_j.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// each row kind's H (21 upper entries, row-major) and g (6), depth at 0 and
// colour at kRow; then the depth and colour squared sums
constexpr int kRow = 27;
constexpr int kSums = 2 * kRow + 2;
constexpr int kPart = kSums + 2;  // an item's partial: kSums floats, then the two counts
constexpr int kMaxCtas = 1024;

struct Params {
  const float* poses;  // [n, 4, 4]
  const void* pa;      // [pairs] int32 or int64 keyframe index of a
  const void* pb;
  int idx64;
  const bool* active;    // [pairs]
  const float* depth;    // [n, h, w]
  const float* points;   // [n, h, w, 3]
  const float* normals;  // [n, h, w, 3]
  const float* inten;    // [n, h, w]
  const float* grad;     // [n, h, w, 2]
  float* partial;        // [pairs, splits, kPart]
  float* jtj;            // [pairs, 12, 12]
  float* jtr;            // [pairs, 12]
  int* n_depth;          // [pairs]
  int* n_color;
  float* ss_depth;
  float* ss_color;
  int pairs, splits, rows, h, w;
  float fx, fy, cx, cy;
  float u_max, v_max;      // project's inside test: u <= width - 1
  float u_inb, v_inb;      // the sampling's in-bounds test: u < w - 1 + 1e-4
  float u_clamp, v_clamp;  // the sampling's clamp: w - 1.001
  float dist_thr, normal_thr, color_thr, grad_min;
  float w_depth, w_color;
};

__device__ __forceinline__ long long pair_index(const Params& prm, const void* idx, int pair) {
  return prm.idx64 ? __ldg(static_cast<const long long*>(idx) + pair)
                   : (long long)__ldg(static_cast<const int*>(idx) + pair);
}

__device__ __forceinline__ float tent(float l, float at) { return fmaxf(1.0f - fabsf(l - at), 0.0f); }

// one channel at the four taps from `base` (pixel index of (v0, u0)),
// `step` floats per pixel: along v, then along u
__device__ __forceinline__ float sample(const float* __restrict__ c, long long base, int w, int step, float tv0,
                                        float tv1, float tu0, float tu1) {
  const float col0 = tv0 * __ldg(c + base * step) + tv1 * __ldg(c + (base + w) * step);
  const float col1 = tv0 * __ldg(c + (base + 1) * step) + tv1 * __ldg(c + (base + w + 1) * step);
  return col0 * tu0 + col1 * tu1;
}

// one Jacobian row [p x v, v] weighted by `wgt` with residual `r` into the
// sums from `first`: H_ij += (wgt * J_i) * J_j for i <= j, g_i += (wgt * J_i) * r
template <int first>
__device__ __forceinline__ void add_row(float (&acc)[kSums], float px, float py, float pz, float v0, float v1,
                                        float v2, float wgt, float r) {
  const float J[6] = {py * v2 - pz * v1, pz * v0 - px * v2, px * v1 - py * v0, v0, v1, v2};
  float wJ[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wJ[i] = wgt * J[i];
  int k = first;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wJ[i] * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[first + 21 + i] += wJ[i] * r;
}

struct Pose {
  float r[3][3], t[3];
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ T) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) p.r[i][j] = __ldg(T + 4 * i + j);
    p.t[i] = __ldg(T + 4 * i + 3);
  }
  return p;
}

// one pixel m of frame a against frame b (fa, fb: frame offsets in pixels)
__device__ __forceinline__ void pixel(const Params& prm, const Pose& A, const Pose& B, const float (&tbi)[3],
                                      long long fa, long long fb, int m, float (&acc)[kSums], int& nd, int& nc) {
  if (!(__ldg(prm.depth + fa + m) > 0.0f)) return;  // no depth: nothing more is read
  const float* pt = prm.points + 3 * (fa + m);
  const float ax = __ldg(pt), ay = __ldg(pt + 1), az = __ldg(pt + 2);
  const float wx = ((A.r[0][0] * ax + A.r[0][1] * ay) + A.r[0][2] * az) + A.t[0];
  const float wy = ((A.r[1][0] * ax + A.r[1][1] * ay) + A.r[1][2] * az) + A.t[1];
  const float wz = ((A.r[2][0] * ax + A.r[2][1] * ay) + A.r[2][2] * az) + A.t[2];
  // into b's camera by T_b^-1 = [R_b^T | -R_b^T t_b]
  const float x = ((B.r[0][0] * wx + B.r[1][0] * wy) + B.r[2][0] * wz) + tbi[0];
  const float y = ((B.r[0][1] * wx + B.r[1][1] * wy) + B.r[2][1] * wz) + tbi[1];
  const float z = ((B.r[0][2] * wx + B.r[1][2] * wy) + B.r[2][2] * wz) + tbi[2];
  const bool zok = z > (float)1e-6;
  const float zs = zok ? z : 1.0f;
  const float u = x / zs * prm.fx + prm.cx;
  const float v = y / zs * prm.fy + prm.cy;
  const bool inside = (u >= 0.0f) & (u <= prm.u_max) & (v >= 0.0f) & (v <= prm.v_max);
  const bool inb = (u >= 0.0f) & (u < prm.u_inb) & (v >= 0.0f) & (v < prm.v_inb);
  if (!(zok & inside & inb)) return;  // NaN coordinates fail here too

  const float uc = fminf(fmaxf(u, 0.0f), prm.u_clamp), vc = fminf(fmaxf(v, 0.0f), prm.v_clamp);
  const float u0 = floorf(uc), v0 = floorf(vc);
  const float tv0 = tent(vc, v0), tv1 = tent(vc, v0 + 1.0f);
  const float tu0 = tent(uc, u0), tu1 = tent(uc, u0 + 1.0f);
  const int w = prm.w;
  const long long base = fb + (long long)((int)v0 * w + (int)u0);
  if (!(sample(prm.depth, base, w, 1, tv0, tv1, tu0, tu1) > 0.0f)) return;
  const float nb0 = sample(prm.normals, base, w, 3, tv0, tv1, tu0, tu1);
  const float nb1 = sample(prm.normals + 1, base, w, 3, tv0, tv1, tu0, tu1);
  const float nb2 = sample(prm.normals + 2, base, w, 3, tv0, tv1, tu0, tu1);
  const float nrm = sqrtf((nb0 * nb0 + nb1 * nb1) + nb2 * nb2);
  if (!(nrm > 0.5f)) return;
  const float n0 = nb0 / nrm, n1 = nb1 / nrm, n2 = nb2 / nrm;
  const float nw0 = (B.r[0][0] * n0 + B.r[0][1] * n1) + B.r[0][2] * n2;
  const float nw1 = (B.r[1][0] * n0 + B.r[1][1] * n1) + B.r[1][2] * n2;
  const float nw2 = (B.r[2][0] * n0 + B.r[2][1] * n1) + B.r[2][2] * n2;
  const float qb0 = sample(prm.points, base, w, 3, tv0, tv1, tu0, tu1);
  const float qb1 = sample(prm.points + 1, base, w, 3, tv0, tv1, tu0, tu1);
  const float qb2 = sample(prm.points + 2, base, w, 3, tv0, tv1, tu0, tu1);
  const float d0 = wx - (((B.r[0][0] * qb0 + B.r[0][1] * qb1) + B.r[0][2] * qb2) + B.t[0]);
  const float d1 = wy - (((B.r[1][0] * qb0 + B.r[1][1] * qb1) + B.r[1][2] * qb2) + B.t[1]);
  const float d2 = wz - (((B.r[2][0] * qb0 + B.r[2][1] * qb1) + B.r[2][2] * qb2) + B.t[2]);
  if (!(sqrtf((d0 * d0 + d1 * d1) + d2 * d2) < prm.dist_thr)) return;
  const float* na = prm.normals + 3 * (fa + m);
  const float na0 = __ldg(na), na1 = __ldg(na + 1), na2 = __ldg(na + 2);
  const float naw0 = (A.r[0][0] * na0 + A.r[0][1] * na1) + A.r[0][2] * na2;
  const float naw1 = (A.r[1][0] * na0 + A.r[1][1] * na1) + A.r[1][2] * na2;
  const float naw2 = (A.r[2][0] * na0 + A.r[2][1] * na1) + A.r[2][2] * na2;
  if (!((naw0 * nw0 + naw1 * nw1) + naw2 * nw2 > prm.normal_thr)) return;

  // the depth row: r = n_w . (p - q_w), J = [p x n_w, n_w | -(...)]
  const float rd = (nw0 * d0 + nw1 * d1) + nw2 * d2;
  add_row<0>(acc, wx, wy, wz, nw0, nw1, nw2, prm.w_depth, rd);
  acc[2 * kRow] += rd * rd;
  nd += 1;

  // the colour row: r = I_a - I_b(pi(h)), J = -[p x c, c | -(...)], c = R_b (g^T dpi/dh)
  const float rc = __ldg(prm.inten + fa + m) - sample(prm.inten, base, w, 1, tv0, tv1, tu0, tu1);
  const float gx = sample(prm.grad, base, w, 2, tv0, tv1, tu0, tu1);
  const float gy = sample(prm.grad + 1, base, w, 2, tv0, tv1, tu0, tu1);
  if (!((fabsf(rc) < prm.color_thr) & (sqrtf(gx * gx + gy * gy) > prm.grad_min))) return;
  const float zz = z * z;
  const float c0 = gx * (prm.fx / z);
  const float c1 = gy * (prm.fy / z);
  const float c2 = gx * (-prm.fx * x / zz) + gy * (-prm.fy * y / zz);
  const float e0 = -((B.r[0][0] * c0 + B.r[0][1] * c1) + B.r[0][2] * c2);
  const float e1 = -((B.r[1][0] * c0 + B.r[1][1] * c1) + B.r[1][2] * c2);
  const float e2 = -((B.r[2][0] * c0 + B.r[2][1] * c1) + B.r[2][2] * c2);
  add_row<kRow>(acc, wx, wy, wz, e0, e1, e2, prm.w_color, rc);
  acc[2 * kRow + 1] += rc * rc;
  nc += 1;
}

__global__ void __launch_bounds__(kThreads) dense_pairs_kernel(const Params prm) {
  __shared__ float s_red[kWarps][kPart];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = prm.h * prm.w;
  const int items = prm.pairs * prm.splits;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int pair = item / prm.splits, split = item - pair * prm.splits;
    if (!prm.active[pair]) continue;  // the same for the whole CTA
    const long long ia = pair_index(prm, prm.pa, pair), ib = pair_index(prm, prm.pb, pair);
    const Pose A = load_pose(prm.poses + 16 * ia), B = load_pose(prm.poses + 16 * ib);
    float tbi[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) tbi[i] = -((B.r[0][i] * B.t[0] + B.r[1][i] * B.t[1]) + B.r[2][i] * B.t[2]);

    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    int nd = 0, nc = 0;
    const int first = split * prm.rows * kThreads + threadIdx.x;
    for (int r = 0; r < prm.rows; ++r) {
      const int m = first + r * kThreads;
      if (m >= hw) break;
      pixel(prm, A, B, tbi, ia * hw, ib * hw, m, acc, nd, nc);
    }

    // the fixed-order reduction: each warp, then the warps' sums
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float x = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
      if (lane == 0) s_red[warp][k] = x;
    }
    nd = __reduce_add_sync(kFull, nd);
    nc = __reduce_add_sync(kFull, nc);
    if (lane == 0) {
      s_red[warp][kSums] = (float)nd;
      s_red[warp][kSums + 1] = (float)nc;
    }
    __syncthreads();
    if (threadIdx.x < kSums + 2) {
      float x[kWarps];
#pragma unroll
      for (int i = 0; i < kWarps; ++i) x[i] = s_red[i][threadIdx.x];
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < off; ++i) x[i] = x[i] + x[i + off];
      }
      prm.partial[(size_t)item * kPart + threadIdx.x] = x[0];
    }
    __syncthreads();
  }
}

// one CTA of 160 threads per slot: JtJ's 144 entries, Jtr's 12, then the
// depth and colour squared sums and counts; a live pair's partials summed
// in split order (depth, then colour, then the two added), every other
// slot zeros
__global__ void __launch_bounds__(160) dense_pairs_finish_kernel(const Params prm) {
  const int pair = blockIdx.x, e = threadIdx.x;
  const bool on = prm.active[pair];
  int src;
  float sign = 1.0f;
  if (e < 144) {
    const int i = e / 12, j = e % 12;
    const int i6 = i % 6, j6 = j % 6;
    const int a = i6 < j6 ? i6 : j6, b = i6 < j6 ? j6 : i6;
    src = a * 6 - a * (a - 1) / 2 + (b - a);
    sign = (i < 6) == (j < 6) ? 1.0f : -1.0f;
  } else if (e < 156) {
    src = 21 + (e - 144) % 6;
    sign = e < 150 ? 1.0f : -1.0f;
  } else {
    src = 2 * kRow + (e - 156);  // the two squared sums, then the two counts
  }
  float v = 0.0f;
  if (on) {
    const float* p = prm.partial + (size_t)pair * prm.splits * kPart + src;
    for (int s = 0; s < prm.splits; ++s) v += p[(size_t)s * kPart];
    if (e < 156) {  // H and g: the colour row's sums added to the depth row's
      float c = 0.0f;
      for (int s = 0; s < prm.splits; ++s) c += p[(size_t)s * kPart + kRow];
      v = v + c;
    }
  }
  if (e < 144) {
    prm.jtj[(size_t)pair * 144 + e] = on ? sign * v : 0.0f;
  } else if (e < 156) {
    prm.jtr[(size_t)pair * 12 + (e - 144)] = on ? sign * v : 0.0f;
  } else if (e == 156) {
    prm.ss_depth[pair] = v;
  } else if (e == 157) {
    prm.ss_color[pair] = v;
  } else if (e == 158) {
    prm.n_depth[pair] = (int)v;
  } else {
    prm.n_color[pair] = (int)v;
  }
}

}  // namespace

extern "C" int bf_dense_pairs(const float* poses, const void* pa, const void* pb, int idx64, const bool* active,
                              const float* depth, const float* points, const float* normals, const float* inten,
                              const float* grad, float* partial, float* jtj, float* jtr, int* n_depth, int* n_color,
                              float* ss_depth, float* ss_color, int pairs, int splits, int rows, int h, int w,
                              float fx, float fy, float cx, float cy, float u_max, float v_max, float u_inb,
                              float v_inb, float u_clamp, float v_clamp, float dist_thr, float normal_thr,
                              float color_thr, float grad_min, float w_depth, float w_color, void* stream) {
  if (pairs == 0) return 0;
  if (splits < 1 || rows < 1 || (long long)splits * rows * kThreads < (long long)h * w || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.poses = poses;
  prm.pa = pa;
  prm.pb = pb;
  prm.idx64 = idx64;
  prm.active = active;
  prm.depth = depth;
  prm.points = points;
  prm.normals = normals;
  prm.inten = inten;
  prm.grad = grad;
  prm.partial = partial;
  prm.jtj = jtj;
  prm.jtr = jtr;
  prm.n_depth = n_depth;
  prm.n_color = n_color;
  prm.ss_depth = ss_depth;
  prm.ss_color = ss_color;
  prm.pairs = pairs;
  prm.splits = splits;
  prm.rows = rows;
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
  prm.grad_min = grad_min;
  prm.w_depth = w_depth;
  prm.w_color = w_color;
  const long long items = (long long)pairs * splits;
  const unsigned ctas = (unsigned)(items < kMaxCtas ? items : kMaxCtas);
  dense_pairs_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(prm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_pairs_finish_kernel<<<(unsigned)pairs, 160, 0, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
