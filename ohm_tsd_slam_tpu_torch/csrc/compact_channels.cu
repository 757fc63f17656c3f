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
// Design: three launches on one stream, no host sync.
//   1. zero the pack;
//   2. one warp per 128-lane row counts its set lanes (four ballots); the
//      same kernel zeroes the prefix's status words;
//   3. a block per tile of 256 rows: csrc/scan_rows.cuh::tile_prefix gives
//      each thread its row's count and the count of all rows before it (a
//      single-pass prefix with a decoupled look-back, shared with
//      csrc/pack_rows.cu), which also stores the total; then place_rows of
//      the same header deals the tile's rows that hold a set lane and start
//      inside the pack to the block's warps: a set lane's slot is its row's
//      offset plus the set lanes before it in the row (ballot + popc), and
//      the lane copies its n_chan values there.
// The Pallas kernel's per-row butterfly, bit-decomposed roll into a staging
// register and sequential grid with SMEM carries exist because the TPU has no
// scatter and no unaligned store; a slot index and a store replace them.
//
// Bound.  Bytes: the mask read once (n or 4n bytes), n_chan * 4 bytes per
// stored lane, the pack written once.  The look-back chain over the tiles is
// the serial part: 128 tiles at n = 4 Mi lanes.

#include <cuda_runtime.h>

#include "scan_rows.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kWarps = 8;       // rows per block in the count kernel
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
                                  int* __restrict__ row_cnt,
                                  unsigned long long* status, int rows) {
  // the prefix of the scatter kernel starts from zeroed status words
  const int n_status = scan_tiles(rows) + 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_status;
       i += gridDim.x * blockDim.x)
    status[i] = 0ull;
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
__global__ void __launch_bounds__(kTileRows)
    scatter_rows_kernel(const MaskT* __restrict__ mask, Channels chans,
                        int n_chan, const int* __restrict__ row_cnt,
                        unsigned long long* status,
                        unsigned* __restrict__ packed,
                        int* __restrict__ total, int rows, int cap) {
  const RowPrefix mine = tile_prefix(row_cnt, rows, status, total);
  place_rows(
      mine, cap, [&](long f) { return is_set<MaskT>(mask[f]); },
      [&](long f, int slot) {
        // unrolled over the capacity so that every chans.p[c] is a fixed
        // kernel parameter (a run-time index would copy the array to a stack
        // frame)
#pragma unroll
        for (int c = 0; c < kMaxChan; ++c)
          if (c < n_chan)
            packed[static_cast<long>(c) * cap + slot] = chans.p[c][f];
        packed[static_cast<long>(n_chan) * cap + slot] = 0x3f800000u;  // 1.0f
      });
}

template <typename MaskT>
cudaError_t run(const void* mask, const Channels& chans, int n_chan, int n,
                int* row_cnt, unsigned long long* status, unsigned* packed,
                int* total, int cap, cudaStream_t st) {
  const MaskT* m = static_cast<const MaskT*>(mask);
  const int rows = n / kRow;
  cudaError_t err = cudaMemsetAsync(
      packed, 0, sizeof(unsigned) * (n_chan + 1L) * cap, st);
  if (err != cudaSuccess) return err;
  count_rows_kernel<MaskT>
      <<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(m, row_cnt,
                                                             status, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_rows_kernel<MaskT><<<scan_tiles(rows), kTileRows, 0, st>>>(
      m, chans, n_chan, row_cnt, status, packed, total, rows, cap);
  return cudaGetLastError();
}

}  // namespace

// mask: n lanes (n % 128 == 0, n >= 128), one byte each (set where nonzero)
// when mask_is_float is 0, float32 each (set where > 0) otherwise; channels:
// host array of n_chan (1..8) device pointers to n float32 each; row_cnt:
// int32 scratch of n / 128; status: scratch of scan_tiles(n / 128) + 1 words
// of 64 bits (csrc/scan_rows.cuh; ceil(n / 32768) + 1); packed:
// [n_chan + 1, cap] float32 output; total: one int32.  All on the device,
// launched on `stream`.  Returns the first cudaError_t.
extern "C" int compact_channels_f32(const void* mask, int mask_is_float,
                                    const void* const* channels, int n_chan,
                                    int n, int* row_cnt,
                                    unsigned long long* status,
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
          ? run<float>(mask, chans, n_chan, n, row_cnt, status, out, total,
                       cap, st)
          : run<unsigned char>(mask, chans, n_chan, n, row_cnt, status, out,
                               total, cap, st);
  return static_cast<int>(err);
}
