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
// Design: a memset and one kernel on one stream, no host sync.  The memset
// zeroes the pack and, behind it in the same buffer, the prefix's status
// words.  A block takes a tile of 256 rows of 128 lanes
// (csrc/scan_rows.cuh::take_tile) and reads the tile's mask once: a byte
// mask by 16-byte vector loads, eight passes of the block over its 32 KB, a
// float mask by one coalesced 128-byte load a warp and a ballot; either way
// the set lanes become a bit a lane in shared memory (4 KB: four 32-bit
// words a row, word q bit j the row's lane 32q + j).  A thread counts its
// row by popc of its four words, row_prefix of the same header gives its
// row's offset (within the tile by a block scan, across tiles by the
// decoupled look-back), and the tile's rows that hold a set lane and start
// inside the pack are listed (list_rows) and dealt to the block's warps: a
// set lane's slot is its row's offset plus the popc of its word below it,
// and the lane copies its n_chan values there.  The mask is never read
// again.  A mask of one tile (at most 32,768 lanes: the map_size 6 path's
// 16,384) takes no ticket, waits on no status word and stores none.
// The Pallas kernel's per-row butterfly, bit-decomposed roll into a staging
// register and sequential grid with SMEM carries exist because the TPU has no
// scatter and no unaligned store; a slot index and a store replace them.
//
// Bound.  Bytes: the mask read once (n or 4n bytes), n_chan * 4 bytes per
// stored lane, the pack written once.  The look-back chain over the tiles is
// the serial part: 128 tiles at n = 4 Mi lanes.

#include <cuda_runtime.h>

#include <cstdint>

#include "scan_rows.cuh"

namespace {

constexpr int kRow = 128;                 // lanes a row
constexpr int kWords = kRow / 32;         // set-lane words a row
constexpr int kTileWarps = kTileRows / 32;
constexpr int kMaxChan = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Channels {
  const unsigned* p[kMaxChan];
};

// bits 0..3: which of the word's four bytes are nonzero
__device__ __forceinline__ unsigned byte_flags(unsigned w) {
  const unsigned nz = __vcmpne4(w, 0u);   // 0xff for each nonzero byte
  return ((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) |
         ((nz >> 28) & 8u);
}

// The set-lane words of the tile whose first row is `row0`: bits[r * 4 + q]
// bit j is lane 32q + j of the tile's row r; rows at or past `rows_here`
// are 0.  Every thread of the block calls this once.
template <typename MaskT>
__device__ __forceinline__ void tile_bits(const MaskT* __restrict__ mask,
                                          long row0, int rows_here,
                                          unsigned* bits);

// a byte mask (set where nonzero): 16-byte chunk c of the tile (row c / 8,
// bytes 16 (c % 8) ..) by thread c % 256 in pass c / 256; the even chunk's
// thread joins its 16 flags with the odd neighbour's into one word
template <>
__device__ __forceinline__ void tile_bits<unsigned char>(
    const unsigned char* __restrict__ mask, long row0, int rows_here,
    unsigned* bits) {
  constexpr int kChunksRow = kRow / 16;
  constexpr int kPasses = kTileRows * kChunksRow / kTileRows;
  const uint4* m = reinterpret_cast<const uint4*>(mask) + row0 * kChunksRow;
  uint4 v[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int c = p * kTileRows + static_cast<int>(threadIdx.x);
    v[p] = c / kChunksRow < rows_here ? m[c] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int c = p * kTileRows + static_cast<int>(threadIdx.x);
    const unsigned f = byte_flags(v[p].x) | (byte_flags(v[p].y) << 4) |
                       (byte_flags(v[p].z) << 8) | (byte_flags(v[p].w) << 12);
    const unsigned odd = __shfl_down_sync(kFull, f, 1);
    if ((c & 1) == 0) bits[c / 2] = f | (odd << 16);
  }
}

// a float mask (set where > 0): word i of the tile (row i / 4, lanes
// 32 (i % 4) ..) is one warp's ballot over one coalesced load
template <>
__device__ __forceinline__ void tile_bits<float>(
    const float* __restrict__ mask, long row0, int rows_here,
    unsigned* bits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* m = mask + row0 * kRow + lane;
#pragma unroll 8
  for (int i = warp; i < kTileRows * kWords; i += kTileWarps) {
    const bool set = i / kWords < rows_here && m[i * 32] > 0.0f;
    const unsigned w = __ballot_sync(kFull, set);
    if (lane == 0) bits[i] = w;
  }
}

template <typename MaskT>
__global__ void __launch_bounds__(kTileRows)
    compact_kernel(const MaskT* __restrict__ mask, Channels chans,
                   int n_chan, unsigned long long* status,
                   unsigned* __restrict__ packed, int* __restrict__ total,
                   int rows, int cap) {
  __shared__ __align__(16) unsigned s_bits[kTileRows * kWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = take_tile(status, scan_tiles(rows));
  const long row0 = static_cast<long>(tile) * kTileRows;
  tile_bits<MaskT>(mask, row0, rows - static_cast<int>(row0), s_bits);
  __syncthreads();
  const uint4 w = reinterpret_cast<const uint4*>(s_bits)[threadIdx.x];
  const RowPrefix mine = row_prefix(
      tile, __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w), rows,
      status, total);
  const RowList list = list_rows(mine, cap);

  for (int i = warp; i < list.n; i += kTileWarps) {  // uniform over the warp
    const int r = list.row[i];
    const long f0 = (row0 + r) * kRow + lane;
    unsigned word[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) word[q] = s_bits[r * kWords + q];
    // every value of the row's set lanes is loaded before the first store,
    // so the loads are in flight together (a store to `packed` could
    // alias a later load for all the compiler knows); the loop is
    // unrolled over the capacity so that every chans.p[c] is a fixed
    // kernel parameter (a run-time index would copy the array to a stack
    // frame)
    unsigned v[kWords][kMaxChan] = {};
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      if ((word[q] >> lane) & 1u) {
#pragma unroll
        for (int c = 0; c < kMaxChan; ++c)
          if (c < n_chan) v[q][c] = __ldg(chans.p[c] + f0 + 32 * q);
      }
    int base = list.off[r];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const int slot = base + __popc(word[q] & ((1u << lane) - 1u));
      if (((word[q] >> lane) & 1u) && slot < cap) {
#pragma unroll
        for (int c = 0; c < kMaxChan; ++c)
          if (c < n_chan)
            packed[static_cast<long>(c) * cap + slot] = v[q][c];
        packed[static_cast<long>(n_chan) * cap + slot] = 0x3f800000u;  // 1.0f
      }
      base += __popc(word[q]);
    }
  }
}

}  // namespace

// mask: n lanes (n % 128 == 0, n >= 128), one byte each (set where nonzero,
// on 16 bytes) when mask_is_float is 0, float32 each (set where > 0)
// otherwise; channels: host array of n_chan (1..8) device pointers to n
// float32 each; packed: [n_chan + 1, cap] float32 output (cap even),
// followed in the same buffer by `n_status` 64-bit words of scratch (at
// least scan_tiles(n / 128) + 1, csrc/scan_rows.cuh), zeroed with the pack;
// total: one int32.  All on the device, launched on `stream`.  Returns the
// first cudaError_t: cudaErrorInvalidValue for a shape it does not take,
// cudaErrorMisalignedAddress for a byte mask off 16 bytes.
extern "C" int compact_channels_f32(const void* mask, int mask_is_float,
                                    const void* const* channels, int n_chan,
                                    int n, float* packed, int n_status,
                                    int* total, int cap, void* stream) {
  const int rows = n / kRow;
  const size_t pack_bytes =
      sizeof(float) * (n_chan + 1L) * static_cast<size_t>(cap);
  if (n_chan < 1 || n_chan > kMaxChan || n < kRow || n % kRow != 0 ||
      n_status < scan_tiles(rows) + 1 || pack_bytes % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!mask_is_float && reinterpret_cast<std::uintptr_t>(mask) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Channels chans;
  for (int c = 0; c < kMaxChan; ++c)
    chans.p[c] = static_cast<const unsigned*>(channels[c < n_chan ? c : 0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      packed, 0, pack_bytes + sizeof(unsigned long long) * n_status, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<char*>(packed) + pack_bytes);
  unsigned* out = reinterpret_cast<unsigned*>(packed);
  if (mask_is_float)
    compact_kernel<float><<<scan_tiles(rows), kTileRows, 0, st>>>(
        static_cast<const float*>(mask), chans, n_chan, status, out, total,
        rows, cap);
  else
    compact_kernel<unsigned char><<<scan_tiles(rows), kTileRows, 0, st>>>(
        static_cast<const unsigned char*>(mask), chans, n_chan, status, out,
        total, rows, cap);
  return static_cast<int>(cudaGetLastError());
}
