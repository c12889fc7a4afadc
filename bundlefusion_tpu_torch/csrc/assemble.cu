// Normal-equation assembly in one launch: the per-pair 12x12 blocks and
// 12-vectors of a Gauss-Newton iteration summed into the dense system
// H [6n, 6n] and b [6n], then the gauge mask and the damping.
//
// Replaces the XLA scatter-adds of bundlefusion_tpu/solver/system.py::
// assemble_system (no Pallas kernel there: the port's own H100 profile put
// PyTorch's deterministic index_add_ at 38% of the card's time). Its plain
// PyTorch twin is bundlefusion_tpu_torch/solver/system.py::
// _assemble_system_torch (today's index_add_ body).
//
// What bounds it on an H100: bytes. Every value of JtJ [P, 12, 12] and Jtr
// [P, 12] is read (a slot's block must be seen to be known to be zero) and
// H is written once: ~12.7 MB for the global solve's 16,384 slots at n =
// 128. The work is a handful of additions per value.
//
// Order, so that the result is bit-equal to the twin on the card: the twin
// adds each cell's updates to +0.0 one by one, the (a,a) updates of every
// slot in slot order, then (a,b), (b,a), (b,b) (four index_add_ calls; the
// deterministic index_put_ sorts stably and sums a run serially from the
// cell's value). b's two calls take PyTorch's small-stride path, which sums
// one call's run from +0.0 and then adds it to the cell: b = S(pa) + S(pb).
// An update whose values are all +-0 is skipped: from a +0.0 start, under
// round-to-nearest, a cell never holds -0.0, so adding +-0 is the identity.
// Values are tested themselves (not the weight), so a NaN still propagates.
//
// Design: one CTA per row R = 6i + r of H (grid n x 6). Empty slots put
// their zero blocks on cell (0, 0), so the CTAs of row 0 see every slot;
// splitting each block row six ways cuts what one CTA must read.
//   1. every thread tests slots in parallel, four at a time with their
//      loads in flight together: for slot s with pa == i it reads row r of
//      the block's top half (the (a,a) and (a,b) updates, three float4),
//      with pb == i row 6 + r of its bottom half ((b,a), (b,b)), and Jtr's
//      entry; one flag bit per non-zero update goes to shared memory.
//   2. six passes in the twin's order ((a,a), (a,b), (b,a), (b,b), then b's
//      two). A pass collects the flagged slots in slot order (block-wide
//      compaction), stages their targets and values in shared memory, and
//      splits them into runs of one target cell. Cell j belongs to one
//      worker of six threads (j mod 42), one thread per column, which adds
//      its runs in order into the cell's running sum in shared memory. No
//      float atomics, no host synchronisation, static shapes.
//   3. the epilogue writes row R: the gauge mask, its identity diagonal and
//      the damping, as the twin's elementwise ops round them.
// Indices outside [0, n) are dropped (the twin raises on them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 2048;            // flagged slots collected per flush (>= one compaction step)
constexpr int kStage = 512;            // items staged in shared memory at a time
constexpr int kWorkers = kThreads / 6; // six threads (one per column) per worker
constexpr int kBatch = 4;              // slots per thread tested together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int load_idx(const void* p, int s, int idx64) {
  return idx64 ? (int)((const long long*)p)[s] : ((const int*)p)[s];
}

// The flags of one half-row of a block (12 values as three float4): ``lo``
// when any of its first six values is not +-0, ``hi`` for its last six
// (NaN != 0).
__device__ __forceinline__ unsigned half_row_flags(const float4 (&v)[3], unsigned lo, unsigned hi) {
  const bool l = (v[0].x != 0.0f) | (v[0].y != 0.0f) | (v[0].z != 0.0f) | (v[0].w != 0.0f) | (v[1].x != 0.0f) |
                 (v[1].y != 0.0f);
  const bool h = (v[1].z != 0.0f) | (v[1].w != 0.0f) | (v[2].x != 0.0f) | (v[2].y != 0.0f) | (v[2].z != 0.0f) |
                 (v[2].w != 0.0f);
  return (l ? lo : 0u) | (h ? hi : 0u);
}

// Exclusive prefix of v over the CTA's threads in thread order; ``total``
// gets the sum. Ends with a barrier, so warp_tot is free again.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    tot += t;
  }
  __syncthreads();
  total = tot;
  return off + x - v;
}

struct Args {
  const void* pa;
  const void* pb;
  int idx64;
  const float* JtJ;  // [P, 12, 12]
  const float* Jtr;  // [P, 12]
  const unsigned char* free_mask;  // [n] bool
  float* H;          // [6n, 6n]
  float* b;          // [6n]
  int n, P;
  float damping, eps;
};

constexpr int kTile = 4 * kThreads;  // slots per compaction step

__host__ __device__ inline int num_tiles(int P) { return (P + kTile - 1) / kTile; }

// Shared memory: acc [6n] | val [kStage * 6] | bacc [2] | list [kList] |
// tgt [kStage] | heads [kStage + 1] | warp_tot [kWarps] | tile_or [tiles] |
// flags [P, padded to 4]
struct Smem {
  float* acc;
  float* val;
  float* bacc;
  int* list;
  int* tgt;
  int* heads;
  int* warp_tot;
  unsigned* tile_or;  // per tile of kTile slots, the OR of its flags
  uint8_t* flags;
};

__device__ Smem carve(char* base, int n, int P) {
  Smem s;
  s.acc = (float*)base;
  s.val = s.acc + 6 * n;
  s.bacc = s.val + kStage * 6;
  s.list = (int*)(s.bacc + 2);
  s.tgt = s.list + kList;
  s.heads = s.tgt + kStage;
  s.warp_tot = s.heads + kStage + 1;
  s.tile_or = (unsigned*)(s.warp_tot + kWarps);
  s.flags = (uint8_t*)(s.tile_or + num_tiles(P));
  return s;
}

size_t smem_bytes(int n, int P) {
  return sizeof(float) * (6 * (size_t)n + kStage * 6 + 2) +
         sizeof(int) * (kList + kStage + kStage + 1 + kWarps + num_tiles(P)) + (((size_t)P + 3) & ~(size_t)3);
}

// Sum the m flagged slots in list[] for pass p into the running sums.
__device__ void flush(const Args& a, const Smem& sm, int i, int r, int p, int m) {
  const bool is_b = p >= 4;
  const int W = is_b ? 1 : 6;
  // offset of the pass's six values (or one) within a slot's block
  const int off = p == 0 ? r * 12 : p == 1 ? r * 12 + 6 : p == 2 ? (6 + r) * 12 : p == 3 ? (6 + r) * 12 + 6
                  : p == 4 ? r : 6 + r;
  for (int k0 = 0; k0 < m; k0 += kStage) {
    const int mm = min(kStage, m - k0);
    for (int k = threadIdx.x; k < mm; k += kThreads) {
      const int s = sm.list[k0 + k];
      sm.tgt[k] = p == 1 ? load_idx(a.pb, s, a.idx64) : p == 2 ? load_idx(a.pa, s, a.idx64) : i;
    }
    for (int e = threadIdx.x; e < mm * W; e += kThreads) {
      const int k = e / W, c = e - k * W;
      const size_t s = (size_t)sm.list[k0 + k];
      sm.val[e] = is_b ? a.Jtr[s * 12 + off] : a.JtJ[s * 144 + off + c];
    }
    __syncthreads();
    if (is_b) {
      if (threadIdx.x == 0) {
        float acc = sm.bacc[p - 4];
        for (int k = 0; k < mm; ++k) acc += sm.val[k];
        sm.bacc[p - 4] = acc;
      }
      __syncthreads();
      continue;
    }
    // runs of one target cell, in order (two items per thread)
    const int k_a = 2 * threadIdx.x, k_b = k_a + 1;
    const bool h_a = k_a < mm && (k_a == 0 || sm.tgt[k_a] != sm.tgt[k_a - 1]);
    const bool h_b = k_b < mm && sm.tgt[k_b] != sm.tgt[k_a];
    int nh;
    const int pos = block_scan((int)h_a + (int)h_b, sm.warp_tot, nh);
    if (h_a) sm.heads[pos] = k_a;
    if (h_b) sm.heads[pos + (int)h_a] = k_b;
    if (threadIdx.x == 0) sm.heads[nh] = mm;
    __syncthreads();
    if (threadIdx.x < kWorkers * 6) {
      const int c = threadIdx.x % 6, q = threadIdx.x / 6;
      for (int h = 0; h < nh; ++h) {
        int k = sm.heads[h];
        const int j = sm.tgt[k];
        if (j % kWorkers != q) continue;
        const int end = sm.heads[h + 1];
        float acc = sm.acc[j * 6 + c];
        for (; k < end; ++k) acc += sm.val[k * 6 + c];
        sm.acc[j * 6 + c] = acc;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) assemble_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  const int i = blockIdx.x, r = blockIdx.y, n = a.n, P = a.P;
  const Smem sm = carve(smem_raw, n, P);
  const int P4 = (P + 3) & ~3;

  for (int e = threadIdx.x; e < 6 * n; e += kThreads) sm.acc[e] = 0.0f;
  for (int t = threadIdx.x; t < num_tiles(P); t += kThreads) sm.tile_or[t] = 0u;
  if (threadIdx.x < 2) sm.bacc[threadIdx.x] = 0.0f;
  __syncthreads();

  // 1. flags: bit 0 (a,a), 1 (a,b), 2 (b,a), 3 (b,b), 4 b at pa, 5 b at pb;
  // kBatch slots per thread have their loads in flight together (the CTAs of
  // row 0 read every empty slot: latency, not bandwidth, bounds them)
  for (int s0 = threadIdx.x; s0 < P4; s0 += kBatch * kThreads) {
    int ia[kBatch], ib[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int s = s0 + q * kThreads;
      ia[q] = s < P ? load_idx(a.pa, s, a.idx64) : -1;
      ib[q] = s < P ? load_idx(a.pb, s, a.idx64) : -1;
    }
    float4 ra[kBatch][3], rb[kBatch][3];
    float ja[kBatch], jb[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const size_t s = (size_t)(s0 + q * kThreads);
      const float4* row_a = (const float4*)(a.JtJ + s * 144 + r * 12);  // 16-byte aligned: the wrapper checks
      const float4* row_b = (const float4*)(a.JtJ + s * 144 + (6 + r) * 12);
      const bool ua = ia[q] == i, ub = ib[q] == i;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ra[q][k] = ua ? __ldg(row_a + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        rb[q][k] = ub ? __ldg(row_b + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      ja[q] = ua ? __ldg(a.Jtr + s * 12 + r) : 0.0f;
      jb[q] = ub ? __ldg(a.Jtr + s * 12 + 6 + r) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int s = s0 + q * kThreads;
      if (s >= P4) break;
      const bool ok_a = (unsigned)ia[q] < (unsigned)n, ok_b = (unsigned)ib[q] < (unsigned)n;
      unsigned f = 0;
      if (ia[q] == i) f |= half_row_flags(ra[q], 1u, ok_b ? 2u : 0u) | (ja[q] != 0.0f ? 16u : 0u);
      if (ib[q] == i) f |= half_row_flags(rb[q], ok_a ? 4u : 0u, 8u) | (jb[q] != 0.0f ? 32u : 0u);
      sm.flags[s] = (uint8_t)f;
      if (f) atomicOr(&sm.tile_or[s / kTile], f);  // integer: which passes a tile feeds
    }
  }
  __syncthreads();

  // 2. the passes, each over the slots in order, four slots per thread per tile
  for (int p = 0; p < 6; ++p) {
    const uint32_t bit = 1u << p;
    int count = 0;
    for (int base = 0; base < P4; base += kTile) {
      if (!(sm.tile_or[base / kTile] & bit)) continue;  // uniform: nothing of this pass here
      const int s0 = base + 4 * threadIdx.x;
      uint32_t f4 = s0 < P4 ? *(const uint32_t*)(sm.flags + s0) : 0u;
      const bool h0 = (f4 & bit) != 0, h1 = ((f4 >> 8) & bit) != 0, h2 = ((f4 >> 16) & bit) != 0,
                 h3 = ((f4 >> 24) & bit) != 0;
      int total;
      const int pos = block_scan((int)h0 + (int)h1 + (int)h2 + (int)h3, sm.warp_tot, total);
      if (count + total > kList) {  // uniform: full list, sum it first
        flush(a, sm, i, r, p, count);
        count = 0;
      }
      int k = count + pos;
      if (h0) sm.list[k++] = s0;
      if (h1) sm.list[k++] = s0 + 1;
      if (h2) sm.list[k++] = s0 + 2;
      if (h3) sm.list[k++] = s0 + 3;
      count += total;
      __syncthreads();
    }
    if (count) flush(a, sm, i, r, p, count);
  }

  // 3. row R of H and b[R]: H * fm * fm^T + diag(1 - fm), then + diag(damping * diag + eps)
  const int R = 6 * i + r, N6 = 6 * n;
  const float fR = a.free_mask[i] ? 1.0f : 0.0f;
  for (int C = threadIdx.x; C < N6; C += kThreads) {
    const float fC = a.free_mask[C / 6] ? 1.0f : 0.0f;
    float h = sm.acc[C] * fR;
    h = h * fC;
    h = h + (C == R ? 1.0f - fR : 0.0f);
    h = h + (C == R ? a.damping * h + a.eps : 0.0f);
    a.H[(size_t)R * N6 + C] = h;
  }
  if (threadIdx.x == 0) {
    const float bv = sm.bacc[0] + sm.bacc[1];
    a.b[R] = (-bv) * fR;
  }
}

}  // namespace

extern "C" int bf_assemble(const void* pa, const void* pb, int idx64, const float* JtJ, const float* Jtr,
                           const unsigned char* free_mask, float* H, float* b, int n, int P, float damping,
                           float eps, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(n, P);
  cudaError_t err = cudaFuncSetAttribute(assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{pa, pb, idx64, JtJ, Jtr, free_mask, H, b, n, P, damping, eps};
  assemble_kernel<<<dim3(n, 6), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
