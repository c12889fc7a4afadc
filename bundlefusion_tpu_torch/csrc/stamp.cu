// Device clock stamps for the pipeline's per-chunk timeline
// (utils/timeline.py): one thread reads %globaltimer (nanoseconds) and
// writes it into an int64 table [rows, cols] at (row, col).
//
// Replaces no TPU kernel: the JAX package has no device timeline. CUDA
// events cannot take this job inside a captured graph (an event captured
// into a graph is the same event at every replay, so with two chunks in
// flight its time is overwritten before the host reads it); a stamp written
// into a table row per chunk is not.
//
// The row is read on the device (row_dev, the step's chunk index) plus a
// fixed offset, so a replayed graph stamps the chunk it runs, not the chunk
// it was captured on; without row_dev (an eager launch) the row comes from
// the host. A row outside the table goes to its last row, the scratch row.
//
// What bounds it: launch latency (~1-2 us between graph nodes); the work is
// one 8-byte load and one 8-byte store.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* table, const int* row_dev, int row, int offset, int rows, int cols, int col) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  int r = (row_dev != nullptr ? *row_dev : row) + offset;
  r = r < 0 ? rows - 1 : (r >= rows ? rows - 1 : r);
  table[(long long)r * cols + col] = (long long)now;
}

}  // namespace

extern "C" int bf_stamp(long long* table, const int* row_dev, int row, int offset, int rows, int cols, int col,
                        void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(table, row_dev, row, offset, rows, cols, col);
  return (int)cudaGetLastError();
}
