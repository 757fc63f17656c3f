// Order-preserving pack of the isocontour segments on Hopper (sm_90a).
//
// Replaces the TPU kernel
// ohm_tsd_slam_tpu/ops/pack_rows_pallas.py::pack_channels_rows_pallas and the
// endpoint recompute around it (grid/raycast_fast.py::_channels_for_rows).
// Contract (grid/raycast_fast.py::pack_rows_plain): for the set lanes of the
// [4, H, W] layer mask of csrc/segment_layers.cu, in flat order, the
// endpoints p0x, p0y, p1x, p1y and a 1.0 validity row, packed into
// [5, cap] float32 with cap = size + 128 (zeros after the last set lane;
// lanes past cap are dropped), and the total count of set lanes.
//
// Design: a memset and one kernel on one stream, no host sync.  The memset
// zeroes the pack and, behind it in the same buffer, the prefix's status
// words.  A block takes a tile of 256 rows of 128 lanes (128 tiles at
// 1024^2): csrc/scan_rows.cuh::tile_prefix gives each thread its row's count
// and the count of all rows before it (a single-pass prefix with a decoupled
// look-back, shared with csrc/compact_channels.cu), then place_rows of the
// same header deals the tile's rows that hold a set lane to the block's
// warps: rows without one (~99%) are never read.  A set lane's slot is its
// row's offset plus the set lanes before it in the row (ballot + popc), and
// the lane computes its endpoints from the field with _quad_segments'
// formulas, in the same operation order, and writes them.
// The Pallas kernel's butterfly, staged rolls and one-hot MXU accumulation
// (and its ROW_CAP row prefilter) exist because the TPU has no scatter; a
// slot index and a store replace them.  A NaN or Inf endpoint would pass
// through unchanged (the one-hot sum turned it into NaN in other slots).
//
// Bound.  Latency: the look-back chain over the tiles; the kernel reads the
// 128 KB of row counts and touches only the rows that hold a segment.
//
// Built with -fmad=false and IEEE division (ops/_build.py): the endpoints
// must equal the twin's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "scan_rows.cuh"

namespace {

constexpr int kRow = 128;  // lanes a row (scan_rows.cuh::place_rows)

__device__ __forceinline__ bool crossing(float a, float b) {
  return (a > 0.0f && b < 0.0f) || (a < 0.0f && b > 0.0f);
}

__device__ __forceinline__ float frac(float a, float b) { return a / (a - b); }

// a0..a3 by index, as selects: an array indexed at run time would live in
// a stack frame
__device__ __forceinline__ float pick(int e, float a0, float a1, float a2,
                                      float a3) {
  return e == 0 ? a0 : e == 1 ? a1 : e == 2 ? a2 : a3;
}

// Endpoints of the segment at flat lane f of the layer mask
// (grid/raycast_fast.py::_quad_segments and the virtual layers of
// _segment_layers).  s: cell size; virt: 0.9 * s.
__device__ __forceinline__ void endpoints(const float* __restrict__ tsd,
                                          int H, int W, long f, float s,
                                          float virt, float& p0x, float& p0y,
                                          float& p1x, float& p1y) {
  const long plane = static_cast<long>(H) * W;
  const int layer = static_cast<int>(f / plane);
  const long q = f - layer * plane;
  const int y = static_cast<int>(q / W);
  const int x = static_cast<int>(q - static_cast<long>(y) * W);
  const float qx = static_cast<float>(x);
  const float qy = static_cast<float>(y);
  const float* r0 = tsd + q;
  const float v00 = r0[0];

  if (layer == 2) {  // virtual h-edge: crossing between (y,x) and (y,x+1)
    const float hx = (qx + 0.5f + frac(v00, r0[1])) * s;
    const float hy = (qy + 0.5f) * s;
    p0x = hx;
    p0y = hy - virt;
    p1x = hx;
    p1y = hy + virt;
    return;
  }
  if (layer == 3) {  // virtual v-edge: crossing between (y,x) and (y+1,x)
    const float vy = (qy + 0.5f + frac(v00, r0[W])) * s;
    const float vx = (qx + 0.5f) * s;
    p0x = vx - virt;
    p0y = vy;
    p1x = vx + virt;
    p1y = vy;
    return;
  }

  const float v01 = r0[1], v10 = r0[W], v11 = r0[W + 1];
  // crossing points on the edges B, R, T, L
  const float Bx = (qx + 0.5f + frac(v00, v01)) * s, By = (qy + 0.5f) * s;
  const float Rx = (qx + 1.5f) * s, Ry = (qy + 0.5f + frac(v01, v11)) * s;
  const float Tx = (qx + 0.5f + frac(v10, v11)) * s, Ty = (qy + 1.5f) * s;
  const float Lx = (qx + 0.5f) * s, Ly = (qy + 0.5f + frac(v00, v10)) * s;
  const bool FB = crossing(v00, v01), FR = crossing(v01, v11);
  const bool FT = crossing(v10, v11), FL = crossing(v00, v10);
  const int n = FB + FR + FT + FL;
  const float den = v00 + v11 - v01 - v10;
  const float saddle =
      fabsf(den) > 0.0f ? (v00 * v11 - v01 * v10) / den : 0.0f;
  const bool same00 = (saddle > 0.0f) == (v00 > 0.0f);

  int e0, e1;
  if (layer == 1) {  // saddle segment 2: (T, L or R)
    e0 = 2;
    e1 = same00 ? 3 : 1;
  } else if (n == 4) {  // saddle segment 1: (B, R or L)
    e0 = 0;
    e1 = same00 ? 1 : 3;
  } else {  // the first and last crossed edge in B, R, T, L order
    e0 = FB ? 0 : FR ? 1 : FT ? 2 : FL ? 3 : 0;
    e1 = FL ? 3 : FT ? 2 : FR ? 1 : FB ? 0 : 3;
  }
  p0x = pick(e0, Bx, Rx, Tx, Lx);
  p0y = pick(e0, By, Ry, Ty, Ly);
  p1x = pick(e1, Bx, Rx, Tx, Lx);
  p1y = pick(e1, By, Ry, Ty, Ly);
}

__global__ void __launch_bounds__(kTileRows)
    pack_rows_kernel(const float* __restrict__ tsd,
                     const float* __restrict__ mask,
                     const int* __restrict__ row_cnt,
                     unsigned long long* status, float* __restrict__ packed,
                     int* __restrict__ total, int H, int W, int rows, int cap,
                     float s, float virt) {
  const RowPrefix mine = tile_prefix(row_cnt, rows, status, total);
  place_rows(
      mine, cap, [&](long f) { return mask[f] > 0.0f; },
      [&](long f, int slot) {
        float p0x, p0y, p1x, p1y;
        endpoints(tsd, H, W, f, s, virt, p0x, p0y, p1x, p1y);
        packed[slot] = p0x;
        packed[cap + slot] = p0y;
        packed[2 * cap + slot] = p1x;
        packed[3 * cap + slot] = p1y;
        packed[4 * cap + slot] = 1.0f;
      });
}

}  // namespace

// tsd [H, W] float32 (W % 128 == 0); mask [4, H, W] float32 0/1 and row_cnt
// [4 * H * W / 128] int32 from segment_layers_f32; packed: [5, cap] float32
// output, followed in the same buffer by `n_status` 64-bit words of scratch
// (at least scan_tiles(rows) + 1, see csrc/scan_rows.cuh), which are zeroed
// with the pack; cap must be even, so that those words lie on 8 bytes (the
// wrapper takes capacities that are multiples of 128); total: one int32.  All
// on the device, launched on `stream`.  Returns the first cudaError_t, and
// cudaErrorInvalidValue for an odd cap or too few status words.
extern "C" int pack_rows_f32(const float* tsd, const float* mask,
                             const int* row_cnt, float* packed, int n_status,
                             int* total, int H, int W, int cap, float s,
                             float virt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(4L * H * W / kRow);
  const int tiles = scan_tiles(rows);
  const size_t pack_bytes = sizeof(float) * 5 * static_cast<size_t>(cap);
  if (rows < 1 || n_status < tiles + 1 || pack_bytes % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      packed, 0, pack_bytes + sizeof(unsigned long long) * n_status, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<char*>(packed) + pack_bytes);
  pack_rows_kernel<<<tiles, kTileRows, 0, st>>>(tsd, mask, row_cnt, status,
                                                packed, total, H, W, rows,
                                                cap, s, virt);
  return static_cast<int>(cudaGetLastError());
}
