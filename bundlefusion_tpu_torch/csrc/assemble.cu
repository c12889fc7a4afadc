// Normal-equation assembly in two launches: the per-pair 12x12 blocks and
// 12-vectors of a Gauss-Newton iteration summed into the dense system
// H [6n, 6n] and b [6n], then the gauge mask and the damping.
//
// Replaces the XLA scatter-adds of bundlefusion_tpu/solver/system.py::
// assemble_system (no Pallas kernel there: the port's own H100 profile put
// PyTorch's deterministic index_add_ at 38% of the card's time). Its plain
// PyTorch twin is bundlefusion_tpu_torch/solver/system.py::
// _assemble_system_torch (the index_add_ body).
//
// What bounds it on an H100: bytes, and the order. Every value of JtJ
// [P, 12, 12] and Jtr [P, 12] is read (a slot's block must be seen to be
// known to be zero) and H is written once: ~12.7 MB for the global solve's
// 16,384 slots at n = 128. The work is a handful of additions per value,
// but a cell's additions form one chain in a fixed order (below), so the
// longest chain of dependent adds bounds it too. Measured, neither does:
// the busiest keyframe's CTA does, one round trip after another (its steps'
// records, its stages' copies, its barriers) and its chains of adds
// (PERF.md).
//
// Order, so that the result is bit-equal to the twin on the card: the twin
// adds each cell's updates to +0.0 one by one, the (a,a) updates of every
// slot in slot order, then (a,b), (b,a), (b,b) (four index_add_ calls; the
// deterministic index_put_ sorts stably and sums a run serially from the
// cell's value). b's two calls take PyTorch's small-stride path, which sums
// one call's run from +0.0 and then adds it to the cell: b = S(pa) + S(pb).
// An update whose values are all +-0 may be skipped: from a +0.0 start,
// under round-to-nearest, a cell never holds -0.0, so adding +-0 is the
// identity. Values are tested themselves (not the weight), so a NaN still
// propagates.
//
// Design: each slot is read once, and a keyframe's rows visit only the
// slots that feed them.
//   1. assemble_flags_kernel, one CTA per sub-tile of 64 slots: their
//      blocks and Jtr rows read once, coalesced as float4, nine loads in
//      flight per thread. A slot's pa side (rows 0-5 of its block,
//      Jtr[0:6]) is live if any value is not +-0, its pb side likewise
//      (rows 6-11, Jtr[6:12]). Each slot gets a record (its two indices,
//      each with its side's live bit, kNone out of [0, n)), and each
//      keyframe one byte per sub-tile: bit 0 a live pa side there, bit 1 a
//      live pb side, bit 2 a self pair (pa = pb) with a live side. All-zero
//      slots drop out here, once.
//   2. assemble_rows_kernel, one CTA per keyframe i and group of rows (all
//      six of block row i where its shared memory fits, n up to 365; else
//      three, two or one),
//      launched to start as pass 1's CTAs finish (programmatic dependent
//      launch: it waits for pass 1's results after clearing its sums).
//      Sweep A walks the steps of 1,024 slots whose flags hold bit 0 or 1:
//      it compacts the slots with a live pa side at i in slot order and
//      flushes them whenever the next step's would not fit a list: 512 at
//      a time, their six rows of 12 values staged in shared memory by
//      cp.async, the left half added to block (i, i) ((a,a)) and the right
//      half to block (i, pb) ((a,b)). Sweep B does the
//      same for the pb side ((b,b) into (i, i), (b,a) into (i, pa)); sweep
//      A collects its items in a second list on the same walk, while they
//      fit, and B resumes where they did not. The two halves of a sweep
//      feed different blocks, so each block still sums in the twin's
//      order; a group of a block's cells belongs to one warp (one lane per
//      cell), which adds its items in order into the cell's running sum in
//      shared memory, block (i, i) to warps of its own. A cross block's
//      warp first lists the stage's items of its target (a ballot per 32
//      items): a global graph's slots interleave their pairs (its
//      compaction keeps them round-robin), so one target's items are rarely
//      next to each other. A self pair's
//      (a,b) and (b,a) updates land on (i, i) between the (a,a) and (b,b)
//      ones: two more sweeps take them, only where bit 2 says there is one.
//      b's sums ride on sweeps A and B. Then the CTA writes its rows: the
//      gauge mask, its identity diagonal and the damping, as the twin's
//      elementwise ops round them.
// Integer flags only (shared-memory atomicOr), no float atomics, no host
// synchronisation, static shapes; shared memory is sized by n, never by P.
// Indices outside [0, n) are dropped (the twin raises on them).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 64;            // slots per pass-1 CTA (and per flag byte)
constexpr int kStep = 4 * kThreads; // slots per compaction step of pass 2: four per thread
constexpr int kSubs = kStep / kSub; // flag bytes per step (one uint4)
constexpr int kList = kStep;        // items a list holds (a step's worth) before its flush
constexpr int kStage = 512;         // items staged at a time
constexpr int kBWarp = 7;           // b's sums; warps 0 .. 6 sum H, a warp per group of a block's cells
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kLive = 0x80000000u;  // record: the slot's side holds a value that is not +-0
constexpr uint32_t kNone = 0x7fffffffu;  // record: the index lies outside [0, n)
constexpr uint32_t kFlagA = 1, kFlagB = 2, kFlagSelf = 4;

__device__ __forceinline__ long long load_idx(const void* p, int s, int idx64) {
  return idx64 ? ((const long long*)p)[s] : (long long)((const int*)p)[s];
}

__device__ __forceinline__ bool nonzero(const float4& v) {
  return (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) | (v.w != 0.0f);  // NaN != 0
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// acc + v[0] + v[stride] + ... + v[(m - 1) * stride], added in this order;
// eight loads run ahead of their adds (the adds' latency, not the loads',
// paces the chain). The loop itself is not unrolled further: every inlined
// copy of it would grow, and with the larger code the local solve's short
// chains ran slower (PERF.md).
__device__ __forceinline__ float chain(float acc, const float* v, int stride, int m) {
  int k = 0;
#pragma unroll 1
  for (; k + 8 <= m; k += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = v[(k + u) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += x[u];
  }
  for (; k < m; ++k) acc += v[k * stride];
  return acc;
}

// The same over the items at positions idx[0 .. m - 1]: acc + v[idx[0] *
// stride] + v[idx[1] * stride] + ...
__device__ __forceinline__ float chain_at(float acc, const float* v, int stride, const int* idx, int m) {
  int k = 0;
#pragma unroll 1
  for (; k + 8 <= m; k += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = v[idx[k + u] * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += x[u];
  }
  for (; k < m; ++k) acc += v[idx[k] * stride];
  return acc;
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
  const float* JtJ;  // [P, 12, 12], 16-byte aligned
  const float* Jtr;  // [P, 12], 16-byte aligned
  const unsigned char* free_mask;  // [n] bool
  float* H;          // [6n, 6n]
  float* b;          // [6n]
  uint2* rec;        // [steps * kStep]: (pa, pb), each | kLive for its side; (kNone, kNone) past P
  uint8_t* flags;    // [n, steps * kSubs]: kFlagA | kFlagB | kFlagSelf per keyframe and sub-tile
  int n, P, steps, rows;
  float damping, eps;
};

__host__ __device__ inline int num_steps(int P) { return (P + kStep - 1) / kStep; }

__host__ __device__ inline int n_words(int n) { return (n + 31) / 32; }

size_t flags_smem_bytes(int n) { return 2 * kSub + sizeof(int) * (size_t)n; }

// 1. the records and the flags
__global__ void __launch_bounds__(kThreads) assemble_flags_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  int* any = (int*)smem_raw;                   // [n]: the flag bits of each keyframe in this sub-tile
  uint8_t* live = (uint8_t*)(any + a.n);       // [kSub][2]: the slot's pa side, pb side
  const int u = blockIdx.x, s0 = u * kSub, m = max(0, min(kSub, a.P - s0)), n = a.n;
  for (int e = threadIdx.x; e < n; e += kThreads) any[e] = 0;
  if (threadIdx.x < 2 * kSub) live[threadIdx.x] = 0;
  __syncthreads();
  // 36 float4 per slot, the first 18 (rows 0-5) the pa side; all of a
  // thread's loads in flight together. Every writer of a flag writes 1.
  const float4* blk = (const float4*)(a.JtJ + (size_t)s0 * 144);
  const int nb = m * 36;
  constexpr int kLoads = kSub * 36 / kThreads;
  float4 v[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    v[q] = e < nb ? __ldg(blk + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // Jtr, 3 float4 per slot: the pa side, then (x, y) pa and (z, w) pb, then pb
  const int ej = threadIdx.x, sj = ej / 3, kj = ej - 3 * sj;
  const float4 vj = ej < m * 3 ? __ldg((const float4*)(a.Jtr + (size_t)s0 * 12) + ej)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (nonzero(v[q])) live[(e / 36) * 2 + ((e % 36) >= 18)] = 1;
  }
  const bool lo = (vj.x != 0.0f) | (vj.y != 0.0f), hi = (vj.z != 0.0f) | (vj.w != 0.0f);
  if (kj == 0 ? (lo | hi) : (kj == 1 && lo)) live[2 * sj] = 1;
  if (kj == 2 ? (lo | hi) : (kj == 1 && hi)) live[2 * sj + 1] = 1;
  __syncthreads();
  if (threadIdx.x < kSub) {
    uint2 r = make_uint2(kNone, kNone);
    if (threadIdx.x < m) {
      const int s = s0 + threadIdx.x;
      const long long ia = load_idx(a.pa, s, a.idx64), ib = load_idx(a.pb, s, a.idx64);
      const bool ok_a = ia >= 0 && ia < n, ok_b = ib >= 0 && ib < n;
      const bool la = live[2 * threadIdx.x], lb = live[2 * threadIdx.x + 1];
      r = make_uint2((ok_a ? (uint32_t)ia : kNone) | (la ? kLive : 0u),
                     (ok_b ? (uint32_t)ib : kNone) | (lb ? kLive : 0u));
      if (la && ok_a) atomicOr(any + ia, (int)kFlagA);
      if (lb && ok_b) atomicOr(any + ib, (int)kFlagB);
      if ((la || lb) && ok_a && ia == ib) atomicOr(any + ia, (int)kFlagSelf);
    }
    a.rec[s0 + threadIdx.x] = r;
  }
  __syncthreads();
  const size_t row = (size_t)a.steps * kSubs;
  for (int j = threadIdx.x; j < n; j += kThreads) a.flags[j * row + u] = (uint8_t)any[j];
}

// Shared memory of pass 2: val [kStage][rows][12] | acc [n][rows][6]
// (block-major) | jval [kStage][rows] | list and tgt A, list and tgt B
// [kList] | pos [kBWarp][kStage] | warp_tot, mask [kWarps] | bacc [2][6] |
// fm [n] | bits [ceil(n / 32)]
struct Smem {
  float* val;
  float* acc;
  float* jval;
  int* list[2];  // a sweep's items (A), and sweep 3's collected during sweep 0 (B)
  int* tgt[2];
  int* pos;       // per warp, a stage's positions of one cross target
  int* warp_tot;
  unsigned* mask;
  float* bacc;
  float* fm;  // the free mask as 1.0 / 0.0
  unsigned* bits;  // the cross targets present in a stage
};

__device__ Smem carve(char* base, int n, int rows) {
  Smem s;
  s.val = (float*)base;  // 16-byte aligned
  s.acc = s.val + kStage * rows * 12;
  s.jval = s.acc + (size_t)n * rows * 6;
  s.list[0] = (int*)(s.jval + kStage * rows);
  s.tgt[0] = s.list[0] + kList;
  s.list[1] = s.tgt[0] + kList;
  s.tgt[1] = s.list[1] + kList;
  s.pos = s.tgt[1] + kList;
  s.warp_tot = s.pos + kBWarp * kStage;
  s.mask = (unsigned*)(s.warp_tot + kWarps);
  s.bacc = (float*)(s.mask + kWarps);
  s.fm = s.bacc + 12;
  s.bits = (unsigned*)(s.fm + n);
  return s;
}

size_t rows_smem_bytes(int n, int rows) {
  return sizeof(float) * ((size_t)kStage * rows * 12 + (size_t)n * rows * 6 + kStage * rows + 4 * kList +
                          kBWarp * kStage + 2 * kWarps + 12 + n + n_words(n));
}

// The OR of keyframe i's flag bytes over step t (0 past the last step).
__device__ __forceinline__ uint32_t step_flags(const Args& a, int i, int t) {
  if (t >= a.steps) return 0u;
  const uint4 v = *(const uint4*)(a.flags + ((size_t)i * a.steps + t) * kSubs);
  uint32_t f = v.x | v.y | v.z | v.w;
  f |= f >> 16;
  return (f | (f >> 8)) & 0xffu;
}

// Sum the m items of sweep p (0: pa = i, (a,a) and (a,b); 1: self pairs'
// (a,b); 2: self pairs' (b,a); 3: pb = i, (b,b) and (b,a)) in list / tgt
// into the CTA's running sums, kStage at a time.
__device__ void flush(const Args& a, const Smem& sm, const int* list, const int* tgt_all, int i, int r0, int rows,
                      int p, int m) {
  const int cells = 6 * rows, side = p >> 1, row0 = 6 * side + r0;
  const bool both = p == 0 || p == 3;            // the block (i, i) and the cross blocks; b's sums
  const int cd = (p == 0 || p == 2) ? 0 : 6;     // columns added to (i, i)
  const int cx = 6 - cd;                         // columns added to (i, tgt) in sweeps 0 and 3
  const int pieces = 3 * rows;
  for (int k0 = 0; k0 < m; k0 += kStage) {
    const int mm = min(kStage, m - k0);
    for (int e = threadIdx.x; e < mm * pieces; e += kThreads) {
      const int k = e / pieces, q = e - k * pieces, rr = q / 3, h = q - 3 * rr;
      const size_t s = (size_t)list[k0 + k];
      cp_async16(sm.val + (k * rows + rr) * 12 + 4 * h, a.JtJ + s * 144 + (row0 + rr) * 12 + 4 * h);
    }
    if (both) {
      for (int e = threadIdx.x; e < mm * rows; e += kThreads) {
        const int k = e / rows, rr = e - k * rows;
        cp_async4(sm.jval + e, a.Jtr + (size_t)list[k0 + k] * 12 + row0 + rr);
      }
    }
    const int words = n_words(a.n);
    if (both) {  // while they land: which cross targets the stage holds
      const int* tgt = tgt_all + k0;
      __syncthreads();  // bits is clear (the kernel's start or the last stage's end)
      for (int k = threadIdx.x; k < mm; k += kThreads) {
        if (tgt[k] >= 0) atomicOr(sm.bits + (tgt[k] >> 5), 1u << (tgt[k] & 31));
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // Warps 0 .. groups - 1 sum block (i, i), a group of cells each (the
    // rows' cells, or half of them when a CTA holds six rows), one lane per
    // cell: the longest chain runs alone. The other warps take the cross
    // blocks' groups, each (target, group) one warp: it lists the stage's
    // items of that target in order (a ballot per 32 items) and adds them.
    // No warp serves two chains at once.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int groups = rows > 3 ? 2 : 1, per = cells / groups;
    if (warp < groups) {
      const int q = warp * per + lane;
      if (lane < per) {
        sm.acc[i * cells + q] =
            chain(sm.acc[i * cells + q], sm.val + (q / 6) * 12 + (q % 6) + cd, rows * 12, mm);
      }
    } else if (warp < kBWarp && both) {
      const int* tgt = tgt_all + k0;
      int* mine = sm.pos + warp * kStage;
      const int others = kBWarp - groups, me = warp - groups;
      int u = 0;  // the (target, group) pairs present, in turn to the other warps
      for (int wi = 0; wi < words; ++wi) {
        for (unsigned word = sm.bits[wi]; word; word &= word - 1, u += groups) {  // uniform across the warp
          const int j = 32 * wi + __ffs(word) - 1;
          if (u % others != me && (groups == 1 || (u + 1) % others != me)) continue;
          int m = 0;
          for (int c = 0; c < mm; c += 32) {
            const bool hit = c + lane < mm && tgt[c + lane] == j;
            const unsigned bal = __ballot_sync(kFull, hit);
            if (hit) mine[m + __popc(bal & ((1u << lane) - 1))] = c + lane;
            m += __popc(bal);
          }
          __syncwarp();
          const bool run = mine[m - 1] - mine[0] + 1 == m;  // one run of consecutive items
          for (int g = 0; g < groups; ++g) {
            const int q = g * per + lane;
            if ((u + g) % others != me || lane >= per) continue;
            const float* v = sm.val + (q / 6) * 12 + (q % 6) + cx;
            sm.acc[j * cells + q] = run ? chain(sm.acc[j * cells + q], v + mine[0] * rows * 12, rows * 12, m)
                                        : chain_at(sm.acc[j * cells + q], v, rows * 12, mine, m);
          }
          __syncwarp();
        }
      }
    } else if (both && lane < rows) {
      sm.bacc[6 * side + lane] = chain(sm.bacc[6 * side + lane], sm.jval + lane, rows, mm);
    }
    __syncthreads();
    if (both) {
      for (int w = threadIdx.x; w < words; w += kThreads) sm.bits[w] = 0u;
    }
  }
}

// The item of sweep p (see flush) that slot (ra, rb) gives keyframe i, if
// any: whether it is one, and its cross target (-1: none, or a self pair's,
// which sweeps 1 and 2 take).
__device__ __forceinline__ bool item(int p, uint32_t ra, uint32_t rb, int i, int& tgt) {
  const uint32_t me = (uint32_t)i | kLive, mine = p < 2 ? ra : rb, other = (p < 2 ? rb : ra) & ~kLive;
  if (p == 0 || p == 3) {
    tgt = other != kNone && other != (uint32_t)i ? (int)other : -1;
    return mine == me;
  }
  tgt = i;
  return mine == me && other == (uint32_t)i;
}

// Sweep p of CTA (i, r0) over the steps from ``from`` flagged for it, in
// slot order, its items in list A, flushed whenever the next step's would
// not fit. ``f0``: this thread's step flags of the first window. Sweep 0
// also walks sweep 3's steps and keeps sweep 3's items in list B while they
// fit (``*nb`` of them); it returns the first step whose sweep-3 items it
// did not keep (a.steps if none), where sweep 3 resumes.
__device__ int sweep(const Args& a, const Smem& sm, int i, int r0, int rows, int p, uint32_t f0, int from, int* nb) {
  const bool with_b = p == 0;
  const uint32_t bit = p == 0 ? kFlagA | kFlagB : p == 3 ? kFlagB : kFlagSelf;
  int na = 0, b_from = a.steps;
  if (with_b) *nb = 0;
  for (int t0 = 0; t0 < a.steps; t0 += kThreads) {
    const uint32_t f = t0 == 0 ? f0 : step_flags(a, i, t0 + threadIdx.x);
    const unsigned bal = __ballot_sync(kFull, (f & bit) != 0);
    if ((threadIdx.x & 31) == 0) sm.mask[threadIdx.x >> 5] = bal;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      for (unsigned bits = sm.mask[w]; bits; bits &= bits - 1) {  // uniform: every thread reads the same word
        const int t = t0 + 32 * w + __ffs(bits) - 1;
        if (t < from) continue;
        const int s = t * kStep + 4 * threadIdx.x;
        const uint4 r01 = *(const uint4*)(a.rec + s), r23 = *(const uint4*)(a.rec + s + 2);
        const uint32_t ra[4] = {r01.x, r01.z, r23.x, r23.z}, rb[4] = {r01.y, r01.w, r23.y, r23.w};
        bool hit[2][4];
        int tg[2][4], cnt = 0;  // list A's count in the low 16 bits, list B's in the high
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hit[0][q] = item(p, ra[q], rb[q], i, tg[0][q]);
          hit[1][q] = with_b && item(3, ra[q], rb[q], i, tg[1][q]);
          cnt += (int)hit[0][q] + ((int)hit[1][q] << 16);
        }
        int total;
        const int pos = block_scan(cnt, sm.warp_tot, total);
        if (na + (total & 0xffff) > kList) {  // uniform: a full list, sum it first
          flush(a, sm, sm.list[0], sm.tgt[0], i, r0, rows, p, na);
          na = 0;
        }
        if (with_b && b_from == a.steps && *nb + (total >> 16) > kList) b_from = t;  // uniform
        const bool keep_b = with_b && b_from == a.steps;
        int k[2] = {na + (pos & 0xffff), keep_b ? *nb + (pos >> 16) : 0};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            if (hit[l][q] && (l == 0 || keep_b)) {
              sm.list[l][k[l]] = s + q;
              sm.tgt[l][k[l]++] = tg[l][q];
            }
          }
        }
        na += total & 0xffff;
        if (keep_b) *nb += total >> 16;
      }
    }
    __syncthreads();  // the lists are complete; mask is free again
  }
  if (na) flush(a, sm, sm.list[0], sm.tgt[0], i, r0, rows, p, na);
  return b_from;
}

// 2. rows 6i + r0 .. 6i + r0 + rows - 1 of H and b
__global__ void __launch_bounds__(kThreads, 1) assemble_rows_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  const int i = blockIdx.x, rows = a.rows, r0 = blockIdx.y * rows, n = a.n, cells = 6 * rows;
  const Smem sm = carve(smem_raw, n, rows);
  for (int e = threadIdx.x; e < n * cells; e += kThreads) sm.acc[e] = 0.0f;
  if (threadIdx.x < 12) sm.bacc[threadIdx.x] = 0.0f;
  for (int w = threadIdx.x; w < n_words(n); w += kThreads) sm.bits[w] = 0u;
  // launched while pass 1 ends (programmatic dependent launch): wait for
  // its records and flags, and every earlier kernel's output, here, after
  // the set-up in shared memory above
  cudaGridDependencySynchronize();
  for (int j = threadIdx.x; j < n; j += kThreads) sm.fm[j] = a.free_mask[j] ? 1.0f : 0.0f;
  // the first window's step flags stay in a register for every sweep
  const uint32_t f0 = step_flags(a, i, threadIdx.x);
  int self = __syncthreads_or((f0 & kFlagSelf) != 0);
  for (int t0 = kThreads; t0 < a.steps; t0 += kThreads)
    self |= __syncthreads_or((step_flags(a, i, t0 + threadIdx.x) & kFlagSelf) != 0);

  int nb;
  const int b_from = sweep(a, sm, i, r0, rows, 0, f0, 0, &nb);
  if (self) {  // uniform
    sweep(a, sm, i, r0, rows, 1, f0, 0, nullptr);
    sweep(a, sm, i, r0, rows, 2, f0, 0, nullptr);
  }
  if (nb) flush(a, sm, sm.list[1], sm.tgt[1], i, r0, rows, 3, nb);
  if (b_from < a.steps) sweep(a, sm, i, r0, rows, 3, f0, b_from, nullptr);

  // H * fm * fm^T + diag(1 - fm), then + diag(damping * diag + eps); two
  // columns of one block per thread (6n is even)
  const int N6 = 6 * n;
  const float fR = sm.fm[i];
  for (int e = 2 * threadIdx.x; e < rows * N6; e += 2 * kThreads) {
    const int rr = e / N6, C = e - rr * N6, R = 6 * i + r0 + rr, j = C / 6;
    const float fC = sm.fm[j];
    float h[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      h[u] = sm.acc[j * cells + rr * 6 + (C + u - 6 * j)] * fR;
      h[u] = h[u] * fC;
      h[u] = h[u] + (C + u == R ? 1.0f - fR : 0.0f);
      h[u] = h[u] + (C + u == R ? a.damping * h[u] + a.eps : 0.0f);
    }
    *(float2*)(a.H + (size_t)R * N6 + C) = make_float2(h[0], h[1]);
  }
  if (threadIdx.x < rows) {
    const float bv = sm.bacc[threadIdx.x] + sm.bacc[6 + threadIdx.x];
    a.b[6 * i + r0 + threadIdx.x] = (-bv) * fR;
  }
}

// cudaFuncSetAttribute once for each kernel, device and size above what it
// was last allowed (not on every launch); the most shared memory a block
// may opt into, read once per device.
std::mutex g_mu;
size_t g_allowed[2][kMaxDevices];
int g_optin[kMaxDevices];

cudaError_t allow_smem(const void* fn, int which, int dev, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_mu);
  if (dev < kMaxDevices && g_allowed[which][dev] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) g_allowed[which][dev] = bytes;
  return err;
}

cudaError_t smem_optin(int dev, int& optin) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (dev < kMaxDevices && g_optin[dev]) {
    optin = g_optin[dev];
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && dev < kMaxDevices) g_optin[dev] = optin;
  return err;
}

}  // namespace

// Bytes of the scratch buffer bf_assemble needs: the records [P rounded up
// to a step of 1,024 slots] and the flags [n, 16 per step].
extern "C" long long bf_assemble_scratch_bytes(int n, int P) {
  return (long long)num_steps(P) * (8LL * kStep + (long long)kSubs * n);
}

extern "C" int bf_assemble(const void* pa, const void* pb, int idx64, const float* JtJ, const float* Jtr,
                           const unsigned char* free_mask, float* H, float* b, void* scratch, int n, int P,
                           float damping, float eps, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = smem_optin(dev, optin);
  if (err != cudaSuccess) return (int)err;
  // the most rows of a block row per CTA whose sums fit in shared memory
  int rows = 6;
  while (rows > 1 && rows_smem_bytes(n, rows) > (size_t)optin) rows = rows == 6 ? 3 : rows - 1;
  const int steps = num_steps(P);
  Args a{pa, pb, idx64, JtJ, Jtr, free_mask, H, b, (uint2*)scratch,
         (uint8_t*)scratch + 8 * (size_t)kStep * steps, n, P, steps, rows, damping, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  if (steps > 0) {
    const size_t smem = flags_smem_bytes(n);
    if ((err = allow_smem((const void*)assemble_flags_kernel, 0, dev, smem)) != cudaSuccess) return (int)err;
    assemble_flags_kernel<<<steps * kSubs, kThreads, smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t smem = rows_smem_bytes(n, rows);
  if ((err = allow_smem((const void*)assemble_rows_kernel, 1, dev, smem)) != cudaSuccess) return (int)err;
  cudaLaunchAttribute early;  // may start as pass 1's CTAs finish
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 6 / rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, assemble_rows_kernel, a)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
