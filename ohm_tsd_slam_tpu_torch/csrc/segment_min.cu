// K-level ray-segment candidate sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel ohm_tsd_slam_tpu/ops/raycast_pallas.py::
// segment_min_pallas.  Contract (grid/raycast_fast.py::segment_min_plain):
// for every beam, the earliest intersection t (in march steps) of the ray
// tr + t * ray with a segment of the pose-independent [8, S] pack, over the
// first `count` segments, in K levels: level 0 is the earliest t >= t_after,
// level k the earliest t >= level k-1 + cover; +inf where there is none.
// Per (segment, beam):
//   denom = cross(ray, e), c1 = cross(ray, p0) - cross(ray, tr),
//   c0 = cross(p0, e) - cross(tr, e), t = c0 / denom, u = -c1 / denom,
//   candidate iff valid, |denom| > eps, u in [0, 1], t in [lo, hi],
//   t >= bound.
//
// Design.  1081 beams make only 9 blocks of 128, so the segment axis is
// split across blocks too: block (i, j) takes beams 128i.. and segments
// 256j.., stages its segments in shared memory, and folds each beam's
// minimum into the output with atomicMin on the float's bits (a valid t is
// >= lo >= 0, where float order is int order; -0.0 is written as +0.0).
// Each level depends on the previous level's final minimum, so a level is
// one launch after the one before on the stream.  A block whose chunk lies
// past `count`, or whose beams all have bound = +inf (resolved beams,
// padding), returns before it loads anything.
//
// Bound.  Arithmetic: ~25 flops and two divisions per pair, 1081 x ~20k
// pairs per level at 1024^2, a few tens of microseconds; the device count is
// read on the device, so the launch never waits on the host.
//
// Built with -fmad=false and IEEE division (ops/_build.py): t and u must
// equal the twin's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBeams = 128;
constexpr int kSegs = 256;
constexpr int kRows = 7;  // pack rows used: ex ey p0x p0y c0p valid eps

__global__ void fill_inf_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = INFINITY;
}

// bound[b] = prev[b * prev_stride] + add
__global__ void segment_min_level(
    const float* __restrict__ pack, int S, const int* __restrict__ count,
    const float* __restrict__ ray, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ prev,
    int prev_stride, float add, const float* __restrict__ tr,
    float* __restrict__ out, int levels, int level, int B) {
  __shared__ float seg[kRows][kSegs];
  const int n = min(*count, S);
  const int j0 = blockIdx.y * kSegs;
  if (j0 >= n) return;  // uniform over the block
  const int b = blockIdx.x * kBeams + threadIdx.x;
  float bound = INFINITY;
  if (b < B) bound = prev[static_cast<long>(b) * prev_stride] + add;
  if (!__syncthreads_or(bound < INFINITY)) return;

  const int m = min(kSegs, n - j0);
  for (int k = threadIdx.x; k < m; k += kBeams) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      seg[r][k] = pack[static_cast<long>(r) * S + j0 + k];
  }
  __syncthreads();
  if (!(bound < INFINITY)) return;

  const float rayx = ray[2 * b], rayy = ray[2 * b + 1];
  const float trx = tr[0], try_ = tr[1];
  const float lob = lo[b], hib = hi[b];
  const float c1tr = rayx * try_ - rayy * trx;  // cross(ray, tr)
  float best = INFINITY;
  for (int k = 0; k < m; ++k) {
    const float ex = seg[0][k], ey = seg[1][k];
    const float p0x = seg[2][k], p0y = seg[3][k];
    const float c0p = seg[4][k], valid = seg[5][k], eps = seg[6][k];
    const float denom = rayx * ey - rayy * ex;        // cross(ray, e)
    const float c1 = (rayx * p0y - rayy * p0x) - c1tr;  // cross(ray, p0-tr)
    const float c0 = c0p - (trx * ey - try_ * ex);      // cross(p0-tr, e)
    const bool ok_denom = fabsf(denom) > eps;
    const float safe = ok_denom ? denom : 1.0f;
    const float t = c0 / safe;
    const float u = -c1 / safe;
    if (valid > 0.0f && ok_denom && u >= 0.0f && u <= 1.0f && t >= lob &&
        t <= hib && t >= bound && t < best)
      best = t;
  }
  if (best < INFINITY) {
    if (best == 0.0f) best = 0.0f;  // -0.0 -> +0.0: int order = float order
    atomicMin(reinterpret_cast<int*>(out) + static_cast<long>(b) * levels +
                  level,
              __float_as_int(best));
  }
}

}  // namespace

// pack [8, S] float32; count: one int32 (valid segments, first in the pack);
// ray [B, 2]; lo, hi, t_after [B]; tr [2] (sensor translation in the pack's
// frame); out [B, levels] float32.  All on the device, launched on `stream`.
// Returns the first cudaError_t.
extern "C" int segment_min_f32(const float* pack, int S, const int* count,
                               const float* ray, const float* lo,
                               const float* hi, const float* t_after,
                               const float* tr, float* out, int B,
                               int levels, float cover, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = B * levels;
  fill_inf_kernel<<<(n_out + 255) / 256, 256, 0, st>>>(out, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kBeams - 1) / kBeams, (S + kSegs - 1) / kSegs);
  for (int k = 0; k < levels; ++k) {
    const float* prev = k == 0 ? t_after : out + (k - 1);
    const int stride = k == 0 ? 1 : levels;
    segment_min_level<<<grid, kBeams, 0, st>>>(
        pack, S, count, ray, lo, hi, prev, stride, k == 0 ? 0.0f : cover, tr,
        out, levels, k, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
