// TSD scan fusion (the mapping push) for float32 grids on Hopper (sm_90a):
// the per-tile cull, the per-cell fusion, the copy of the untouched tiles
// and the tile bookkeeping in one launch.
//
// Replaces the TPU kernel ohm_tsd_slam_tpu/ops/push_pallas.py::push_pallas
// together with the cull that the JAX package leaves to XLA
// (ohm_tsd_slam_tpu/grid/push.py::tile_cull).  It computes what
// grid/push.py::push computes: TsdGridComponent::isInRange per tile
// (TsdGridComponent.cpp:43-124), then per cell of the tiles it selects
// TsdGrid::push (TsdGrid.cpp:217-284), addTsd (TsdGridPartition.h:170-212)
// and increaseEmptiness (TsdGridPartition.cpp:136-164).
//
// Design.  XLA fuses the cull into a handful of device ops; eager torch runs
// it as some sixty ops over [TY, TX, beams] tensors, a hundred times the
// kernel's own time.  So every CUDA block owns one tile and decides for
// itself: each thread computes the tile's centroid distance, range window
// and four corner bins (a few dozen operations, the same in every thread,
// so the decision is uniform over the block without a broadcast), the
// threads stride the beams of the corner span for the two reductions
// (__syncthreads_or / __syncthreads_and), and thread 0 writes the tile's
// new tile_init and tile_initw.  The kernel writes out of place: the
// caller's grid is never written (a reader of the old grid may still hold
// it), an active tile writes its fused cells and an inactive tile copies
// its cells through, so no separate copy of the grid runs before the
// launch.  Each thread back-projects its cell with atan2f and loads its
// beam straight from the scan (about a thousand floats, resident in L1/L2);
// the mask folds into that load.
//
// The decisions must equal grid/push.py::tile_cull's, which runs in float32
// op by op: the operation order is the twin's, and the build has no FMA
// contraction and IEEE division and square root (ops/_build.py).
//
// Bound.  Bytes: tsd and weight are read once and written once, 16 B a
// cell, 16 MB for a 1024^2 grid, about 5 us at 3.35 TB/s; the scan, the
// mask and the tile arrays are a few KB.
//
// Built without --use_fast_math: the NaN tests and atan2f's accuracy need
// IEEE semantics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kTsdInc = 1.0f;  // TSDINC (reconstruct_defs.h:6)
// backProject's out-of-bounds codes (sensor/polar2d.py)
constexpr int kBelowFov = -2;
constexpr int kAboveFov = -1;

struct PushParams {
  int W, tile_dim, tiles_x, n_beams;
  float cell_size, tile_size, circumradius, trunc, max_weight;
  float phi_min, angular_res, phi_lo, phi_hi;
  float max_range, min_range, low_refl;
};

// the sensor pose and its inverse's translation, as core/se2.py::invert
// builds it: local = R^T p - R^T t
struct Pose {
  float r00, r01, t0, r10, r11, t1, i02, i12;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ pose) {
  Pose T;
  T.r00 = pose[0], T.r01 = pose[1], T.t0 = pose[2];
  T.r10 = pose[3], T.r11 = pose[4], T.t1 = pose[5];
  T.i02 = -(T.r00 * T.t0 + T.r10 * T.t1);
  T.i12 = -(T.r01 * T.t0 + T.r11 * T.t1);
  return T;
}

// sensor/polar2d.py::back_project of the world point (x, y): the beam bin,
// or kBelowFov / kAboveFov (SensorPolar2D::backProject)
__device__ __forceinline__ int back_project(const PushParams& p,
                                            const Pose& T, float x, float y) {
  const float lx = T.r00 * x + T.r10 * y + T.i02;
  const float ly = T.r01 * x + T.r11 * y + T.i12;
  const float phi = atan2f(ly, lx);
  int idx =
      static_cast<int>(floorf((phi - p.phi_min) / p.angular_res + 0.5f));
  if (phi <= p.phi_lo) idx = kBelowFov;
  if (phi >= p.phi_hi) idx = kAboveFov;
  return idx;
}

__global__ void tsd_push_kernel(const float* __restrict__ tsd_in,
                                const float* __restrict__ weight_in,
                                const bool* __restrict__ tile_init_in,
                                const float* __restrict__ tile_initw_in,
                                const float* __restrict__ data,
                                const bool* __restrict__ mask,
                                const float* __restrict__ pose,
                                float* __restrict__ tsd_out,
                                float* __restrict__ weight_out,
                                bool* __restrict__ tile_init_out,
                                float* __restrict__ tile_initw_out,
                                float* __restrict__ cull_out, PushParams p) {
  const int tx = blockIdx.x;
  const int ty = blockIdx.y;
  const int tile = ty * p.tiles_x + tx;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const Pose T = load_pose(pose);
  const float tile_f = static_cast<float>(p.tile_dim);

  // ---- the cull (grid/push.py::tile_cull), the same in every thread ----
  // tile centroid and circumradius (TsdGridPartition.cpp:65-70)
  const float centroid_off = (tile_f + 1.0f) * 0.5f;
  const float cx = (static_cast<float>(tx) * tile_f + centroid_off) *
                   p.cell_size;
  const float cy = (static_cast<float>(ty) * tile_f + centroid_off) *
                   p.cell_size;
  const float cdx = cx - T.t0;
  const float cdy = cy - T.t1;
  const float distance = sqrtf(cdx * cdx + cdy * cdy);
  const float closest = distance - p.circumradius - p.trunc;
  const float farthest = distance + p.circumradius + p.trunc;
  // range-window tests (TsdGridComponent.cpp:49-58)
  const bool in_window = closest <= p.max_range && farthest >= p.min_range;

  // corner back-projection (TsdGridComponent.cpp:66-93): the cell centres
  // of the corner cells (TsdGridPartition.cpp:48-63)
  const float x0 = (static_cast<float>(tx) * tile_f + 0.5f) * p.cell_size;
  const float y0 = (static_cast<float>(ty) * tile_f + 0.5f) * p.cell_size;
  const float x1 = x0 + p.tile_size;
  const float y1 = y0 + p.tile_size;
  bool any_visible = false, all_visible = true;
  int min_idx = p.n_beams, max_idx = -1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int idx = back_project(p, T, (c & 1) ? x1 : x0, (c & 2) ? y1 : y0);
    const bool seen = idx != kBelowFov && idx != kAboveFov;
    any_visible = any_visible || seen;
    all_visible = all_visible && seen;
    if (idx == kAboveFov) idx = p.n_beams - 1;
    if (idx == kBelowFov) idx = 0;
    min_idx = min(min_idx, idx);
    max_idx = max(max_idx, idx);
  }

  // beam-span reductions (TsdGridComponent.cpp:96-114) over the span only;
  // a tile that fails before them takes no decision from the scan
  const bool candidate = in_window && any_visible;  // uniform over the block
  bool visible = false, empty = true;
  if (candidate) {
    const bool close_by = distance < p.low_refl;
    const int last = min(max_idx, p.n_beams - 1);
    for (int b = max(min_idx, 0) + tid; b <= last; b += n_threads) {
      const float d = data[b];
      const bool m = mask[b];
      visible = visible || (d > closest && m);
      empty = empty && (isinf(d) ? close_by : (d > farthest && m));
    }
  }
  const bool is_visible = __syncthreads_or(visible);
  const bool is_empty = __syncthreads_and(empty);
  const bool base = candidate && is_visible;
  const bool empty_inc = base && all_visible && is_empty;
  const bool touch = base && !empty_inc;
  const float dist_clamped = fminf(distance, p.max_range);
  const float ratio = (p.max_range - dist_clamped) / p.max_range;
  const float part_w = ratio * ratio;  // TsdGrid.cpp:239-243

  // ---- tile bookkeeping (push's tile_init, next_tile_initw) ----
  const bool was_init = tile_init_in[tile];
  const float init_w = tile_initw_in[tile];
  if (tid == 0) {
    tile_init_out[tile] = was_init || touch;
    tile_initw_out[tile] = (empty_inc && !was_init)
                               ? fminf(init_w + 1.0f, p.max_weight)
                               : init_w;
    if (cull_out != nullptr) {
      cull_out[3 * tile + 0] = touch ? 1.0f : 0.0f;
      cull_out[3 * tile + 1] = empty_inc ? 1.0f : 0.0f;
      cull_out[3 * tile + 2] = part_w;
    }
  }
  const bool cell_empty_inc = empty_inc && was_init;
  const bool newly_init = touch && !was_init;
  const bool new_empty = newly_init && init_w > 0.0f;
  const bool new_plain = newly_init && !new_empty;
  const bool active = touch || cell_empty_inc;  // uniform over the block

  const float eps = -p.cell_size * 0.5f;  // dead surface boost (push.py)
  for (int r = threadIdx.y; r < p.tile_dim; r += blockDim.y) {
    const int iy = ty * p.tile_dim + r;
    for (int c = threadIdx.x; c < p.tile_dim; c += blockDim.x) {
      const int ix = tx * p.tile_dim + c;
      const long cell = static_cast<long>(iy) * p.W + ix;
      float tsd0 = tsd_in[cell];
      float w0 = weight_in[cell];
      if (!active) {  // copy the tile through
        tsd_out[cell] = tsd0;
        weight_out[cell] = w0;
        continue;
      }

      // materialize a newly initialized tile (TsdGridPartition::init)
      if (new_empty) {
        tsd0 = kTsdInc;
        w0 = init_w;
      } else if (new_plain) {
        tsd0 = nanf("");
        w0 = 0.0f;
      }

      // back-projection (SensorPolar2D::backProject); NaN = masked beam
      const float x = (static_cast<float>(ix) + 0.5f) * p.cell_size;
      const float y = (static_cast<float>(iy) + 0.5f) * p.cell_size;
      const int idx = back_project(p, T, x, y);
      const int beam = min(max(idx, 0), p.n_beams - 1);
      const float d = mask[beam] ? data[beam] : nanf("");

      // addTsd (TsdGrid.cpp:246-274 + TsdGridPartition.h:170-212)
      const float dx = x - T.t0;
      const float dy = y - T.t1;
      const float dist = sqrtf(dx * dx + dy * dy);
      const bool finite = !isinf(d);
      const float sd = finite ? d - dist : p.trunc;
      const bool do_add =
          idx >= 0 && !isnan(d) && (finite || dist < p.low_refl);
      float tsd1 = tsd0;
      float w1 = w0;
      if (touch && do_add && sd >= -p.trunc) {
        const float tsd_new = fminf(sd / p.trunc, kTsdInc);
        const float w_meas = (fabsf(sd) < eps ? 1.0f : 0.01f) * part_w;
        const float denom = w0 + w_meas;
        if (isnan(tsd0)) {
          tsd1 = tsd_new;
          w1 = denom;
        } else {
          tsd1 = (tsd0 * w0 + tsd_new * w_meas) / denom;
          w1 = fminf(denom, p.max_weight);
        }
      }

      // increaseEmptiness (TsdGridPartition.cpp:136-164)
      if (cell_empty_inc) {
        if (isnan(tsd1)) {
          w1 = w1 + 1.0f;
          tsd1 = kTsdInc;
        } else {
          w1 = fminf(w1 + 1.0f, p.max_weight);
          tsd1 = (tsd1 * (w1 - 1.0f) + 1.0f) / w1;
        }
      }
      tsd_out[cell] = tsd1;
      weight_out[cell] = w1;
    }
  }
}

}  // namespace

// One push on `stream`, out of place.  In: tsd, weight [H, W] float32
// row-major, tile_init [TY, TX] bool, tile_initw [TY, TX] float32 (H and W
// whole multiples of tile_dim), data [n_beams] ranges, mask [n_beams] bool,
// pose the 3x3 row-major sensor pose; all on the device.  Out: the four
// arrays of the new grid and, where cull_out is not null, the cull's
// decisions [TY, TX, 3] (touch, empty_inc as 0/1, part_weight).  The
// float parameters are the float32 values the plain version's scalars
// round to.  Returns the cudaError_t of the launch.
extern "C" int tsd_push_f32(
    const float* tsd_in, const float* weight_in, const bool* tile_init_in,
    const float* tile_initw_in, const float* data, const bool* mask,
    const float* pose, float* tsd_out, float* weight_out,
    bool* tile_init_out, float* tile_initw_out, float* cull_out, int H,
    int W, int tile_dim, int n_beams, float cell_size, float tile_size,
    float circumradius, float trunc, float max_weight, float phi_min,
    float angular_res, float phi_lo, float phi_hi, float max_range,
    float min_range, float low_refl, void* stream) {
  PushParams p;
  p.W = W;
  p.tile_dim = tile_dim;
  p.tiles_x = W / tile_dim;
  p.n_beams = n_beams;
  p.cell_size = cell_size;
  p.tile_size = tile_size;
  p.circumradius = circumradius;
  p.trunc = trunc;
  p.max_weight = max_weight;
  p.phi_min = phi_min;
  p.angular_res = angular_res;
  p.phi_lo = phi_lo;
  p.phi_hi = phi_hi;
  p.max_range = max_range;
  p.min_range = min_range;
  p.low_refl = low_refl;
  const dim3 grid(p.tiles_x, H / tile_dim);
  const dim3 block(32, 8);
  tsd_push_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tsd_in, weight_in, tile_init_in, tile_initw_in, data, mask, pose,
      tsd_out, weight_out, tile_init_out, tile_initw_out, cull_out, p);
  return static_cast<int>(cudaGetLastError());
}
