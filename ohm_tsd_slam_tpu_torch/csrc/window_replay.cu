// Exact-march window replay with crossing normals on Hopper (sm_90a).
//
// Replaces the TPU kernels ohm_tsd_slam_tpu/ops/window_block_pallas.py::
// window_block_pallas (blocks of 16 beams sharing one patch) and
// window_single_pallas (one patch per beam, for deferred beams and rounds
// 2..4).  Contract (grid/raycast_fast.py::window_replay_plain): per active
// beam, the march of RayCastPolar2D.cpp:237-270 over WINDOW = 8 samples
// t = tw0 + j: bilinear taps in interpolate_bilinear's summation order
// (out-of-grid taps read NaN), +→− a hit, −→+ a back face, NaN samples
// invalid, sample pairs only while t - 1 <= idx_max; then the sub-cell
// interpolation of the first event and the central-difference normal there
// (grid/interpolate.py::interpolate_normal).  Output [N, 8]: hit, any_ev,
// pos_x, pos_y, interp, nx, ny, n_ok; zeros for an inactive beam.
//
// Design.  One thread per beam reads its taps straight from the field in
// global memory.  The patches, their fit test and the defer pass of the
// Pallas kernels work around the TPU's slow gathers; a per-beam gather is
// cheap here, so one kernel serves round 1 (all beams) and the compacted
// rounds alike, and no beam can miss its patch.  The tile-initialization
// check of interpolate_bilinear is left out: a cell of a never-initialized
// tile is NaN in the dense field (the push writes only tiles it touches,
// and initializes them), so its blend is NaN all the same.
//
// Bound.  Latency: 48 dependent-free tap loads per beam from L2, 1081 beams
// (9 blocks of 128) in round 1 and 256 slots per later round.
//
// Built with -fmad=false and IEEE division and sqrt (ops/_build.py): the
// samples, and so the events, must equal the twin's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWindow = 8;  // grid/raycast_fast.py::WINDOW

struct Field {
  const float* tsd;
  int H, W;
  float s;
};

__device__ __forceinline__ float cell(const Field& g, int ix, int iy) {
  return (ix < g.W && iy < g.H) ? g.tsd[static_cast<long>(iy) * g.W + ix]
                                : NAN;
}

// interpolate_bilinear at world (px, py): NaN when the base cell is off the
// grid or a tap is NaN or off the grid
__device__ float bilinear(const Field& g, float px, float py) {
  const float u = px / g.s - 0.5f;
  const float v = py / g.s - 0.5f;
  const float fx = floorf(u);
  const float fy = floorf(v);
  if (!(fx >= 0.0f && fx < g.W && fy >= 0.0f && fy < g.H)) return NAN;
  const float wx = u - fx;
  const float wy = v - fy;
  const int ix = static_cast<int>(fx);
  const int iy = static_cast<int>(fy);
  const float v00 = cell(g, ix, iy);
  const float v10 = cell(g, ix, iy + 1);
  const float v01 = cell(g, ix + 1, iy);
  const float v11 = cell(g, ix + 1, iy + 1);
  // TsdGridPartition::interpolateBilinear's order (TsdGridPartition.h:214-221)
  return v00 * (1.0f - wy) * (1.0f - wx) + v10 * wy * (1.0f - wx) +
         v01 * (1.0f - wy) * wx + v11 * wy * wx;
}

__global__ void window_replay_kernel(Field g, const float* __restrict__ tw0,
                                     const float* __restrict__ ray,
                                     const float* __restrict__ idx_max,
                                     const bool* __restrict__ active,
                                     const float* __restrict__ tr,
                                     float* __restrict__ out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float* o = out + static_cast<long>(i) * 8;
  if (!active[i]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) o[c] = 0.0f;
    return;
  }
  const float t0 = tw0[i], rx = ray[2 * i], ry = ray[2 * i + 1];
  const float im = idx_max[i], trx = tr[0], try_ = tr[1];

  float t[kWindow], px[kWindow], py[kWindow], v[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    t[j] = t0 + static_cast<float>(j);
    px[j] = trx + t[j] * rx;
    py[j] = try_ + t[j] * ry;
    v[j] = bilinear(g, px[j], py[j]);
  }

  // first event among the sample pairs (j, j+1)
  int k = -1;
  bool pos_k = false;
#pragma unroll
  for (int j = 0; j < kWindow - 1; ++j) {
    const bool ok = (t[j + 1] - 1.0f) <= im;
    const bool ev_pos = v[j] > 0.0f && v[j + 1] < 0.0f && ok;
    const bool ev_neg = v[j] < 0.0f && v[j + 1] > 0.0f && ok;
    if (k < 0 && (ev_pos || ev_neg)) {
      k = j;
      pos_k = ev_pos;
    }
  }
  const bool any_ev = k >= 0;
  if (k < 0) k = 0;  // as the twin's argmax: the first pair
  const float vp = v[k], vc = v[k + 1];
  const float interp = vp / (vp - vc);
  const float pos_x = px[k + 1], pos_y = py[k + 1];

  // crossing point and its central-difference normal
  const float cx = pos_x + rx * (interp - 1.0f);
  const float cy = pos_y + ry * (interp - 1.0f);
  const float xp = bilinear(g, cx + g.s, cy);
  const float xm = bilinear(g, cx - g.s, cy);
  const float yp = bilinear(g, cx, cy + g.s);
  const float ym = bilinear(g, cx, cy - g.s);
  const bool n_ok = !(isnan(xp) || isnan(xm) || isnan(yp) || isnan(ym));
  const float nx = xp - xm;
  const float ny = yp - ym;
  const float norm = sqrtf(nx * nx + ny * ny);
  const float den = norm > 0.0f ? norm : 1.0f;

  o[0] = (any_ev && pos_k) ? 1.0f : 0.0f;
  o[1] = any_ev ? 1.0f : 0.0f;
  o[2] = pos_x;
  o[3] = pos_y;
  o[4] = interp;
  o[5] = n_ok ? nx / den : NAN;
  o[6] = n_ok ? ny / den : NAN;
  o[7] = n_ok ? 1.0f : 0.0f;
}

}  // namespace

// tsd [H, W] float32; tw0, idx_max [N]; ray [N, 2]; active [N] bool; tr [2]
// (sensor translation, world frame); out [N, 8] float32.  All on the
// device, launched on `stream`.  Returns the cudaError_t of the launch.
extern "C" int window_replay_f32(const float* tsd, int H, int W, float s,
                                 const float* tw0, const float* ray,
                                 const float* idx_max, const bool* active,
                                 const float* tr, float* out, int N,
                                 void* stream) {
  const Field g{tsd, H, W, s};
  constexpr int kThreads = 128;
  window_replay_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, tw0, ray, idx_max, active, tr, out, N);
  return static_cast<int>(cudaGetLastError());
}
