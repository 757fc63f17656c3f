// TSD scan fusion (the mapping push) for float32 grids on Hopper (sm_90a).
//
// Replaces the TPU kernel ohm_tsd_slam_tpu/ops/push_pallas.py::push_pallas.
// It computes what grid/push.py::push computes per cell (TsdGrid::push,
// TsdGrid.cpp:217-284; addTsd, TsdGridPartition.h:170-212;
// increaseEmptiness, TsdGridPartition.cpp:136-164) for the tiles that the
// per-tile cull (grid/push.py::tile_cull, run in torch on the device) marks
// as touched or empty-on-init.
//
// Design.  The Pallas kernel restricted each block's beam lookup to an
// angular span (an SMEM select loop fed by a corner prepass) and compacted
// the active blocks with jnp.nonzero behind a scalar-prefetch grid: both
// exist only because the TPU has no cheap gather.  Here every CUDA block
// owns one tile, reads the tile's six meta values and returns at once when
// the tile has no cell-level work, so no compaction and no host sync are
// needed.  Each thread back-projects its cell with atan2f and loads its
// beam straight from the table (about a thousand floats, resident in
// L1/L2).
//
// Bound.  Bytes: an active cell reads and writes tsd and weight (16 B in
// all), so even a fully active 1024^2 grid moves 16 MB, about 5 us at
// 3.35 TB/s.  The wrapper's grid copy, the torch tile cull and the launch
// latency cost more than the kernel itself.
//
// Built without --use_fast_math: the NaN tests and atan2f's accuracy need
// IEEE semantics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kTsdInc = 1.0f;  // TSDINC (reconstruct_defs.h:6)

// tile meta channels, as stacked by ops/push_cuda.py
enum { kTouch = 0, kEmptyInc, kNewPlain, kNewEmpty, kInitW, kPartW, kMeta };

struct PushParams {
  int H, W, tile_dim, tiles_x, n_beams;
  float cell_size, trunc, max_weight;
  float phi_min, angular_res, phi_lo, phi_hi, low_refl;
};

__global__ void tsd_push_kernel(float* __restrict__ tsd,
                                float* __restrict__ weight,
                                const float* __restrict__ table,
                                const float* __restrict__ meta,
                                const float* __restrict__ pose,
                                PushParams p) {
  const int tx = blockIdx.x;
  const int ty = blockIdx.y;
  const float* m = meta + (static_cast<long>(ty) * p.tiles_x + tx) * kMeta;
  const bool touch = m[kTouch] > 0.0f;
  const bool empty_inc = m[kEmptyInc] > 0.0f;
  if (!touch && !empty_inc) return;  // uniform over the block
  const bool new_plain = m[kNewPlain] > 0.0f;
  const bool new_empty = m[kNewEmpty] > 0.0f;
  const float init_w = m[kInitW];
  const float part_w = m[kPartW];

  // pose^-1 in closed form, as core/se2.py::invert: local = R^T p - R^T t
  const float r00 = pose[0], r01 = pose[1], t0 = pose[2];
  const float r10 = pose[3], r11 = pose[4], t1 = pose[5];
  const float i02 = -(r00 * t0 + r10 * t1);
  const float i12 = -(r01 * t0 + r11 * t1);
  const float eps = -p.cell_size * 0.5f;  // dead surface boost (push.py)

  for (int r = threadIdx.y; r < p.tile_dim; r += blockDim.y) {
    const int iy = ty * p.tile_dim + r;
    if (iy >= p.H) break;
    for (int c = threadIdx.x; c < p.tile_dim; c += blockDim.x) {
      const int ix = tx * p.tile_dim + c;
      if (ix >= p.W) break;
      const long cell = static_cast<long>(iy) * p.W + ix;

      // materialize a newly initialized tile (TsdGridPartition::init)
      float tsd0 = tsd[cell];
      float w0 = weight[cell];
      if (new_empty) {
        tsd0 = kTsdInc;
        w0 = init_w;
      } else if (new_plain) {
        tsd0 = nanf("");
        w0 = 0.0f;
      }

      // back-projection (SensorPolar2D::backProject)
      const float x = (static_cast<float>(ix) + 0.5f) * p.cell_size;
      const float y = (static_cast<float>(iy) + 0.5f) * p.cell_size;
      const float lx = r00 * x + r10 * y + i02;
      const float ly = r01 * x + r11 * y + i12;
      const float phi = atan2f(ly, lx);
      const bool in_fov = phi > p.phi_lo && phi < p.phi_hi;
      int idx = static_cast<int>(
          floorf((phi - p.phi_min) / p.angular_res + 0.5f));
      idx = min(max(idx, 0), p.n_beams - 1);
      const float d = table[idx];  // NaN = masked beam

      // addTsd (TsdGrid.cpp:246-274 + TsdGridPartition.h:170-212)
      const float dx = x - t0;
      const float dy = y - t1;
      const float dist = sqrtf(dx * dx + dy * dy);
      const bool finite = !isinf(d);
      const float sd = finite ? d - dist : p.trunc;
      const bool do_add =
          in_fov && !isnan(d) && (finite || dist < p.low_refl);
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
      if (empty_inc) {
        if (isnan(tsd1)) {
          w1 = w1 + 1.0f;
          tsd1 = kTsdInc;
        } else {
          w1 = fminf(w1 + 1.0f, p.max_weight);
          tsd1 = (tsd1 * (w1 - 1.0f) + 1.0f) / w1;
        }
      }
      tsd[cell] = tsd1;
      weight[cell] = w1;
    }
  }
}

}  // namespace

// Updates tsd and weight ([H, W] float32, row-major) in place on `stream`.
// table: [n_beams] ranges, NaN for masked beams; meta: [TY, TX, 6] tile
// meta; pose: the 3x3 row-major sensor pose, on the device.  Returns the
// cudaError_t of the launch.
extern "C" int tsd_push_f32(float* tsd, float* weight, const float* table,
                            const float* meta, const float* pose, int H,
                            int W, int tile_dim, int n_beams, float cell_size,
                            float trunc, float max_weight, float phi_min,
                            float angular_res, float phi_lo, float phi_hi,
                            float low_refl, void* stream) {
  PushParams p;
  p.H = H;
  p.W = W;
  p.tile_dim = tile_dim;
  p.tiles_x = (W + tile_dim - 1) / tile_dim;
  p.n_beams = n_beams;
  p.cell_size = cell_size;
  p.trunc = trunc;
  p.max_weight = max_weight;
  p.phi_min = phi_min;
  p.angular_res = angular_res;
  p.phi_lo = phi_lo;
  p.phi_hi = phi_hi;
  p.low_refl = low_refl;
  const dim3 grid(p.tiles_x, (H + tile_dim - 1) / tile_dim);
  const dim3 block(32, 8);
  tsd_push_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tsd, weight, table, meta, pose, p);
  return static_cast<int>(cudaGetLastError());
}
