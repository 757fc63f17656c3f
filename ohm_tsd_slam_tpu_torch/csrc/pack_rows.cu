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
// Design: three launches on one stream, no host sync.
//   1. an exclusive scan of the 128-lane row counts that segment_layers
//      wrote (one block, csrc/scan_rows.cuh; 32768 rows at 1024^2), which
//      also stores the total;
//   2. one warp per row: rows without a set lane return at once (~99% of
//      them); a set lane's slot is its row's offset plus the set lanes
//      before it in the row (ballot + popc), and the lane computes its
//      endpoints from the field with _quad_segments' formulas, in the same
//      operation order, and writes them.
// The Pallas kernel's butterfly, staged rolls and one-hot MXU accumulation
// (and its ROW_CAP row prefilter) exist because the TPU has no scatter; a
// slot index and a store replace them.  A NaN or Inf endpoint would pass
// through unchanged (the one-hot sum turned it into NaN in other slots).
//
// Bound.  Latency: the scan is one block; the pack reads 512 KB of row
// counts and offsets and touches only the nonzero rows.
//
// Built with -fmad=false and IEEE division (ops/_build.py): the endpoints
// must equal the twin's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "scan_rows.cuh"

namespace {

constexpr int kRow = 128;

__device__ __forceinline__ bool crossing(float a, float b) {
  return (a > 0.0f && b < 0.0f) || (a < 0.0f && b > 0.0f);
}

__device__ __forceinline__ float frac(float a, float b) { return a / (a - b); }

// Endpoints of the segment at flat lane f of the layer mask
// (grid/raycast_fast.py::_quad_segments and the virtual layers of
// _segment_layers).  s: cell size; virt: 0.9 * s.
__device__ void endpoints(const float* __restrict__ tsd, int H, int W,
                          long f, float s, float virt, float* p) {
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
    p[0] = hx;
    p[1] = hy - virt;
    p[2] = hx;
    p[3] = hy + virt;
    return;
  }
  if (layer == 3) {  // virtual v-edge: crossing between (y,x) and (y+1,x)
    const float vy = (qy + 0.5f + frac(v00, r0[W])) * s;
    const float vx = (qx + 0.5f) * s;
    p[0] = vx - virt;
    p[1] = vy;
    p[2] = vx + virt;
    p[3] = vy;
    return;
  }

  const float v01 = r0[1], v10 = r0[W], v11 = r0[W + 1];
  // crossing points on the edges B, R, T, L
  const float Px[4] = {(qx + 0.5f + frac(v00, v01)) * s, (qx + 1.5f) * s,
                       (qx + 0.5f + frac(v10, v11)) * s, (qx + 0.5f) * s};
  const float Py[4] = {(qy + 0.5f) * s, (qy + 0.5f + frac(v01, v11)) * s,
                       (qy + 1.5f) * s, (qy + 0.5f + frac(v00, v10)) * s};
  const bool F[4] = {crossing(v00, v01), crossing(v01, v11),
                     crossing(v10, v11), crossing(v00, v10)};
  const int n = F[0] + F[1] + F[2] + F[3];
  const float den = v00 + v11 - v01 - v10;
  const float saddle =
      fabsf(den) > 0.0f ? (v00 * v11 - v01 * v10) / den : 0.0f;
  const bool same00 = (saddle > 0.0f) == (v00 > 0.0f);

  if (layer == 1) {  // saddle segment 2: (T, L or R)
    const int e1 = same00 ? 3 : 1;
    p[0] = Px[2];
    p[1] = Py[2];
    p[2] = Px[e1];
    p[3] = Py[e1];
    return;
  }
  int e0, e1;
  if (n == 4) {  // saddle segment 1: (B, R or L)
    e0 = 0;
    e1 = same00 ? 1 : 3;
  } else {  // the first and last crossed edge in B, R, T, L order
    e0 = F[0] ? 0 : F[1] ? 1 : F[2] ? 2 : F[3] ? 3 : 0;
    e1 = F[3] ? 3 : F[2] ? 2 : F[1] ? 1 : F[0] ? 0 : 3;
  }
  p[0] = Px[e0];
  p[1] = Py[e0];
  p[2] = Px[e1];
  p[3] = Py[e1];
}

__global__ void pack_rows_kernel(const float* __restrict__ tsd,
                                 const float* __restrict__ mask,
                                 const int* __restrict__ row_cnt,
                                 const int* __restrict__ row_off,
                                 float* __restrict__ packed, int H, int W,
                                 int rows, int cap, float s, float virt) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows || row_cnt[row] == 0) return;  // uniform over the warp
  int base = row_off[row];
  if (base >= cap) return;
  for (int sub = 0; sub < kRow; sub += 32) {
    const long f = static_cast<long>(row) * kRow + sub + lane;
    const bool set = mask[f] > 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    const int slot = base + __popc(ballot & ((1u << lane) - 1u));
    if (set && slot < cap) {
      float p[4];
      endpoints(tsd, H, W, f, s, virt, p);
      packed[slot] = p[0];
      packed[cap + slot] = p[1];
      packed[2 * cap + slot] = p[2];
      packed[3 * cap + slot] = p[3];
      packed[4 * cap + slot] = 1.0f;
    }
    base += __popc(ballot);
  }
}

}  // namespace

// tsd [H, W] float32 (W % 128 == 0); mask [4, H, W] float32 0/1 and row_cnt
// [4 * H * W / 128] int32 from segment_layers_f32; row_off: int32 scratch
// like row_cnt; packed: [5, cap] float32 output; total: one int32.  All on
// the device, launched on `stream`.  Returns the first cudaError_t.
extern "C" int pack_rows_f32(const float* tsd, const float* mask,
                             const int* row_cnt, int* row_off, float* packed,
                             int* total, int H, int W, int cap, float s,
                             float virt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(4L * H * W / kRow);
  cudaError_t err =
      cudaMemsetAsync(packed, 0, sizeof(float) * 5L * cap, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_rows_kernel<<<1, kScanThreads, 0, st>>>(row_cnt, row_off, total, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kWarps = 8;
  pack_rows_kernel<<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
      tsd, mask, row_cnt, row_off, packed, H, W, rows, cap, s, virt);
  return static_cast<int>(cudaGetLastError());
}
