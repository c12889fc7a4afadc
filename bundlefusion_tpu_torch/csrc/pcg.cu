// Jacobi-preconditioned conjugate gradients on a dense normal-equation
// system H x = b (H [6n, 6n] f32, row-major), the whole fixed-count solve
// in one launch: the preconditioner, every iteration's H p, both dot
// products and the vector updates.
//
// Replaces no Pallas kernel: the JAX package's bundlefusion_tpu/solver/
// system.py::pcg_solve is a lax.fori_loop of a matvec and elementwise
// updates that XLA fuses on the TPU. The port ran the same loop on the card
// as one cuBLAS gemv of the whole [6n, 6n] matrix and ~14 small elementwise
// and dot launches per iteration. Its plain PyTorch twin is
// bundlefusion_tpu_torch/solver/system.py::_pcg_solve_torch, which is that
// loop.
//
// What it skips, with the same result. The rows of a slot that is not free
// are gauge-fixed by the assembly (K3): an identity-scaled diagonal, no
// off-diagonal terms, and b = 0, so r, z, p and x stay exactly 0 there and
// add exact zeros to every other row. So only the leading L = 6 (f + 1)
// rows and columns are solved, f the last free slot, found here from
// free_mask (no host read); x is 0 past them. Once rz <= tol every later
// iteration of the twin is a masked no-op (rz frozen), so the loop stops
// there. The preconditioner guards (|diag| > 1e-12, |pAp| > 1e-20,
// rz > 1e-20), tol and the vector updates are the twin's op by op; only the
// matvec and the dot products sum in another (fixed) order.
//
// What bounds it on an H100: the iterations are a chain, each a product
// with the live block (L^2 floats: 3.1 MB at 146 keyframes), two
// reductions and their barriers. Design: one thread-block cluster of up to
// 16 CTAs (chosen at launch from the slot count n; a cluster of one for a
// block that one CTA's shared memory holds, as the local solve's 66 x 66).
// CTA k owns the row stripe [k S, (k + 1) S), S = ceil(L / C), and keeps as
// many of its rows of H in shared memory as fit, loaded once; the rest are
// read from global memory (L2) in every iteration. Every CTA keeps full
// copies of p, r, x, the preconditioner and Ap. An iteration: each warp
// multiplies up to four stripe rows at once with p (lane-strided fmaf sums,
// a shuffle tree), the CTA sums its stripe's p.Ap in warp order, writes its
// Ap stripe and that partial into every CTA's shared memory (DSMEM, double
// buffered by iteration parity), one cluster barrier, then every CTA forms
// the same p.Ap (partials in rank order), updates the full x and r, sums
// r.z in a fixed order and updates p: the CTAs compute bit-identical
// vectors without exchanging them again, and all leave the loop together.
// No atomics on values, nothing allocated; reruns are bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kRowsAtOnce = 4;  // the rows a warp multiplies per pass over p
constexpr int kVectors = 6;     // p, r, the preconditioner, x, Ap twice
// shared floats besides the vectors: the p.Ap partials [2][kMaxCluster] and
// one partial per warp
constexpr int kExtra = 2 * kMaxCluster + 32;
constexpr int kWideThreads = 512;
constexpr int kSmallThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* H;
  const float* b;
  const bool* free_mask;
  float* x;
  float* rz_out;
  int* counts;  // live rows, iterations run
  int n;
  int num_iters;
  float tol;
  int smem_floats;
};

// lane 0 gets the warp's sum, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// the block's sum, the same value in every thread: warps' sums in warp
// order. `red` must not be written again before a barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kWideThreads) pcg_kernel(Params prm) {
  extern __shared__ float sm[];
  __shared__ int last_free;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = blockDim.x, W = B >> 5;
  const long long ld = 6LL * prm.n;

  // the live bound: rows up to the last free slot's
  if (tid == 0) last_free = -1;
  __syncthreads();
  int mine = -1;
  for (int i = tid; i < prm.n; i += B)
    if (prm.free_mask[i]) mine = i;
  for (int o = 16; o > 0; o >>= 1) mine = max(mine, __shfl_down_sync(kFull, mine, o));
  if (lane == 0 && mine >= 0) atomicMax(&last_free, mine);
  __syncthreads();
  const int L = 6 * (last_free + 1);

  float* p = sm;
  float* r = p + L;
  float* minv = r + L;
  float* xs = minv + L;
  float* ap2 = xs + L;  // [2][L]
  float* part2 = ap2 + 2 * L;  // [2][kMaxCluster]
  float* red = part2 + 2 * kMaxCluster;  // [32]
  float* Hs = red + 32;
  const int S = (L + C - 1) / C;
  const int r0 = min(L, rank * S), r1 = min(L, r0 + S);
  const int room = L > 0 ? (prm.smem_floats - kVectors * L - kExtra) / L : 0;
  const int hold = max(0, min(r1 - r0, room));

  // x = 0, r = b, z = Minv r, p = z; the stripe's rows that fit, once
  float acc = 0.0f;
  for (int j = tid; j < L; j += B) {
    const float d = prm.H[j * ld + j];
    const float mi = fabsf(d) > 1e-12f ? 1.0f / d : 0.0f;
    const float bj = prm.b[j];
    const float z = mi * bj;
    minv[j] = mi;
    r[j] = bj;
    p[j] = z;
    xs[j] = 0.0f;
    acc = fmaf(bj, z, acc);
  }
  for (int q = warp; q < hold; q += W) {
    const float* src = prm.H + (r0 + q) * ld;
    float* dst = Hs + q * L;
    for (int j = lane; j < L; j += 32) dst[j] = src[j];
  }
  float rz = block_sum(acc, red);
  cluster.sync();  // every CTA running (DSMEM) and done reading `red`

  int it = 0;
  for (; it < prm.num_iters && rz > prm.tol; ++it) {
    float* ap = ap2 + (it & 1) * L;
    float* part = part2 + (it & 1) * kMaxCluster;

    // the stripe of H p, and its share of p.Ap (lane 0 of each warp, row order)
    float wsum = 0.0f;
    for (int i0 = r0 + warp * kRowsAtOnce; i0 < r1; i0 += W * kRowsAtOnce) {
      const float* row[kRowsAtOnce];
      float a[kRowsAtOnce];
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q) {
        const int i = min(i0 + q, r1 - 1);  // past the stripe: a row again, its sum unused
        row[q] = i - r0 < hold ? Hs + (i - r0) * L : prm.H + i * ld;
        a[q] = 0.0f;
      }
      for (int j = lane; j < L; j += 32) {
        const float pj = p[j];
#pragma unroll
        for (int q = 0; q < kRowsAtOnce; ++q) a[q] = fmaf(row[q][j], pj, a[q]);
      }
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q) {
        const float v = warp_sum(a[q]);
        if (lane == 0 && i0 + q < r1) {
          ap[i0 + q] = v;
          wsum = fmaf(p[i0 + q], v, wsum);
        }
      }
    }
    if (lane == 0) red[warp] = wsum;
    __syncthreads();

    // the stripe and the CTA's partial into every CTA of the cluster
    if (tid == 0) {
      float s = 0.0f;
      for (int w = 0; w < W; ++w) s += red[w];
      for (int k = 0; k < C; ++k) cluster.map_shared_rank(part, k)[rank] = s;
    }
    const int rows = r1 - r0;
    for (int idx = tid; idx < rows * (C - 1); idx += B) {
      int k = idx / rows;
      k += k >= rank;
      const int i = r0 + idx % rows;
      cluster.map_shared_rank(ap, k)[i] = ap[i];
    }
    cluster.sync();

    // the same in every CTA: alpha, x, r, r.z, beta, p
    float pAp = 0.0f;
    for (int k = 0; k < C; ++k) pAp += part[k];
    const float alpha = fabsf(pAp) > 1e-20f ? rz / pAp : 0.0f;
    acc = 0.0f;
    for (int j = tid; j < L; j += B) {
      const float pj = p[j];
      xs[j] = xs[j] + alpha * pj;
      const float rj = r[j] - alpha * ap[j];
      r[j] = rj;
      acc = fmaf(rj, minv[j] * rj, acc);
    }
    const float rz_new = block_sum(acc, red);
    const float beta = rz > 1e-20f ? rz_new / rz : 0.0f;
    for (int j = tid; j < L; j += B) p[j] = minv[j] * r[j] + beta * p[j];
    rz = rz_new;
    __syncthreads();  // p whole before the next product; `red` read by all
  }

  // the stripe's x, and 0 past the live rows
  for (int j = r0 + tid; j < r1; j += B) prm.x[j] = xs[j];
  for (long long j = L + (long long)rank * B + tid; j < ld; j += (long long)C * B) prm.x[j] = 0.0f;
  if (rank == 0 && tid == 0) {
    *prm.rz_out = rz;
    prm.counts[0] = L;
    prm.counts[1] = it;
  }
}

int available_smem(int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, pcg_kernel);
  *bytes = optin - (int)fa.sharedSizeBytes;
  return (int)err;
}

}  // namespace

// The launch shape for n slots: a cluster of one CTA of kSmallThreads when
// the vectors and all of H fit in its shared memory (exactly that much);
// otherwise the largest cluster of kWideThreads CTAs that the card can
// place with all the shared memory a CTA may have. Sets the kernel's
// attributes. cudaErrorInvalidValue when the vectors alone do not fit.
extern "C" int bf_pcg_config(int n, int* cluster, int* threads, int* smem_bytes) {
  int avail = 0;
  int err = available_smem(&avail);
  if (err != 0) return err;
  const long long m = 6LL * n;
  const long long vec = (kVectors * m + kExtra) * 4;
  if (n < 1 || vec > avail) return (int)cudaErrorInvalidValue;
  err = (int)cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, avail);
  if (err == 0) err = (int)cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != 0) return err;
  if (vec + m * m * 4 <= avail) {
    *cluster = 1;
    *threads = kSmallThreads;
    *smem_bytes = (int)(vec + m * m * 4);
    return 0;
  }
  *threads = kWideThreads;
  *smem_bytes = avail;
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kWideThreads);
    cfg.dynamicSmemBytes = avail;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int fits = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&fits, pcg_kernel, &cfg);
    if (err != 0) return err;
    if (fits >= 1) {
      *cluster = c;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" int bf_pcg(const float* H, const float* b, const bool* free_mask, float* x, float* rz, int* counts,
                      int n, int num_iters, float tol, int cluster, int threads, int smem_bytes, void* stream) {
  if (n < 1 || num_iters < 0 || cluster < 1 || cluster > kMaxCluster || threads % 32 != 0 || threads < 32
      || threads > kWideThreads || (long long)smem_bytes < (kVectors * 6LL * n + kExtra) * 4)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.H = H;
  prm.b = b;
  prm.free_mask = free_mask;
  prm.x = x;
  prm.rz_out = rz;
  prm.counts = counts;
  prm.n = n;
  prm.num_iters = num_iters;
  prm.tol = tol;
  prm.smem_floats = smem_bytes / 4;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pcg_kernel, prm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
