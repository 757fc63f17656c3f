// Order-preserving compaction of a flat mask with its value channels on
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// ohm_tsd_slam_tpu/ops/compact_pallas.py::compact_channels_pallas.
// Contract (grid/compact.py::pack_channels_rows): for the set lanes of a flat
// mask of n lanes (n % 128 == 0), in flat order, the value of each of n_chan
// dense float32 channels and a 1.0 validity row, packed into
// [n_chan + 1, cap] float32 with cap = size + 128: zeros after the last set
// lane, lanes past cap dropped, and the count of ALL set lanes (which may
// exceed cap).  A channel value is copied as 32 bits, never computed with, so
// NaN and Inf pass through with their payload.
//
// Design: four launches on one stream, no host sync.
//   1. zero the pack;
//   2. one warp per 128-lane row counts its set lanes (four ballots);
//   3. an exclusive scan of the row counts by one block, which also stores
//      the total (csrc/scan_rows.cuh, shared with csrc/pack_rows.cu);
//   4. one warp per row: rows without a set lane, or wholly past cap, return
//      at once; a set lane's slot is its row's offset plus the set lanes
//      before it in the row (ballot + popc), and the lane copies its n_chan
//      values there.
// The Pallas kernel's per-row butterfly, bit-decomposed roll into a staging
// register and sequential grid with SMEM carries exist because the TPU has no
// scatter and no unaligned store; a slot index and a store replace them.
//
// Bound.  Bytes: the mask read once (n or 4n bytes), n_chan * 4 bytes per
// stored lane, the pack written once.  The one-block scan is the serial part:
// 32768 row counts at n = 4 Mi lanes.

#include <cuda_runtime.h>

#include "scan_rows.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kWarps = 8;       // rows per block in the row kernels
constexpr int kMaxChan = 8;

struct Channels {
  const unsigned* p[kMaxChan];
};

template <typename MaskT>
__device__ __forceinline__ bool is_set(MaskT v);
template <>
__device__ __forceinline__ bool is_set<unsigned char>(unsigned char v) {
  return v != 0;
}
template <>
__device__ __forceinline__ bool is_set<float>(float v) {
  return v > 0.0f;
}

template <typename MaskT>
__global__ void count_rows_kernel(const MaskT* __restrict__ mask,
                                  int* __restrict__ row_cnt, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  int cnt = 0;
  for (int sub = 0; sub < kRow; sub += 32) {
    const long f = static_cast<long>(row) * kRow + sub + lane;
    cnt += __popc(__ballot_sync(0xffffffffu, is_set<MaskT>(mask[f])));
  }
  if (lane == 0) row_cnt[row] = cnt;
}

template <typename MaskT>
__global__ void scatter_rows_kernel(const MaskT* __restrict__ mask,
                                    Channels chans, int n_chan,
                                    const int* __restrict__ row_cnt,
                                    const int* __restrict__ row_off,
                                    unsigned* __restrict__ packed, int rows,
                                    int cap) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows || row_cnt[row] == 0) return;  // uniform over the warp
  int base = row_off[row];
  if (base >= cap) return;
  for (int sub = 0; sub < kRow; sub += 32) {
    const long f = static_cast<long>(row) * kRow + sub + lane;
    const bool set = is_set<MaskT>(mask[f]);
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    const int slot = base + __popc(ballot & ((1u << lane) - 1u));
    if (set && slot < cap) {
      // unrolled over the capacity so that every chans.p[c] is a fixed
      // kernel parameter (a run-time index would copy the array to a stack
      // frame)
#pragma unroll
      for (int c = 0; c < kMaxChan; ++c)
        if (c < n_chan)
          packed[static_cast<long>(c) * cap + slot] = chans.p[c][f];
      packed[static_cast<long>(n_chan) * cap + slot] = 0x3f800000u;  // 1.0f
    }
    base += __popc(ballot);
  }
}

template <typename MaskT>
cudaError_t run(const void* mask, const Channels& chans, int n_chan, int n,
                int* row_cnt, int* row_off, unsigned* packed, int* total,
                int cap, cudaStream_t st) {
  const MaskT* m = static_cast<const MaskT*>(mask);
  const int rows = n / kRow;
  const int blocks = (rows + kWarps - 1) / kWarps;
  cudaError_t err = cudaMemsetAsync(
      packed, 0, sizeof(unsigned) * (n_chan + 1L) * cap, st);
  if (err != cudaSuccess) return err;
  count_rows_kernel<MaskT><<<blocks, 32 * kWarps, 0, st>>>(m, row_cnt, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_rows_kernel<<<1, kScanThreads, 0, st>>>(row_cnt, row_off, total, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_rows_kernel<MaskT><<<blocks, 32 * kWarps, 0, st>>>(
      m, chans, n_chan, row_cnt, row_off, packed, rows, cap);
  return cudaGetLastError();
}

}  // namespace

// mask: n lanes (n % 128 == 0, n >= 128), one byte each (set where nonzero)
// when mask_is_float is 0, float32 each (set where > 0) otherwise; channels:
// host array of n_chan (1..8) device pointers to n float32 each; row_cnt,
// row_off: int32 scratch of n / 128 each; packed: [n_chan + 1, cap] float32
// output; total: one int32.  All on the device, launched on `stream`.
// Returns the first cudaError_t.
extern "C" int compact_channels_f32(const void* mask, int mask_is_float,
                                    const void* const* channels, int n_chan,
                                    int n, int* row_cnt, int* row_off,
                                    float* packed, int* total, int cap,
                                    void* stream) {
  if (n_chan < 1 || n_chan > kMaxChan || n < kRow || n % kRow != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Channels chans;
  for (int c = 0; c < kMaxChan; ++c)
    chans.p[c] = static_cast<const unsigned*>(channels[c < n_chan ? c : 0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* out = reinterpret_cast<unsigned*>(packed);
  const cudaError_t err =
      mask_is_float
          ? run<float>(mask, chans, n_chan, n, row_cnt, row_off, out, total,
                       cap, st)
          : run<unsigned char>(mask, chans, n_chan, n, row_cnt, row_off, out,
                               total, cap, st);
  return static_cast<int>(err);
}
