// Exclusive scan of the 128-lane row counts, shared by the two compactions
// (csrc/pack_rows.cu and csrc/compact_channels.cu).
//
// One block of kScanThreads threads: each sums a contiguous run of rows, a
// Hillis-Steele scan in shared memory turns the sums into offsets, and each
// thread writes its rows' offsets.  This is the serial part of both
// compactions (32768 rows at 4 Mi lanes).
//
// Launch: scan_rows_kernel<<<1, kScanThreads, 0, stream>>>(...).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;

// row_off = exclusive scan of row_cnt[0..rows); *total = the sum.
__global__ void scan_rows_kernel(const int* __restrict__ row_cnt,
                                 int* __restrict__ row_off,
                                 int* __restrict__ total, int rows) {
  __shared__ int part[kScanThreads];
  const int per = (rows + kScanThreads - 1) / kScanThreads;
  const int r0 = min(static_cast<int>(threadIdx.x) * per, rows);
  const int r1 = min(r0 + per, rows);
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += row_cnt[r];
  part[threadIdx.x] = sum;
  __syncthreads();
  // Hillis-Steele inclusive scan of the per-thread sums
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;  // exclusive
  for (int r = r0; r < r1; ++r) {
    row_off[r] = run;
    run += row_cnt[r];
  }
  if (threadIdx.x == kScanThreads - 1) *total = part[kScanThreads - 1];
}

}  // namespace
