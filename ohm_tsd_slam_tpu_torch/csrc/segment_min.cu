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
// Design: one launch for every level, a block of four warps a beam.  The
// beam's 128 lanes stride the segments, each keeps its own minimum, and a
// shuffle reduction and one barrier give the beam's level; every thread then
// holds that level in a register, adds `cover` and sweeps again.  A beam has
// one owner, so there is no atomic in global memory and no fill of the
// output, and no block waits for another: 1081 beams are 1081 blocks, some
// ten of them resident on each of the 132 SMs.  A beam's sweep is a chain of
// loads and divisions, so its time is their latency: four warps a beam cut
// the chain to a quarter of a warp's and put enough warps on an SM to hide it
// at any segment count (a warp a beam was measured four times slower than
// the sweep it replaced at 32768 segments).  A lane starts the loads of four
// pairs together.
// Level 0 computes each pair's t once.  Few pairs are candidates whatever the
// bound (the beam must cross the segment inside [lo, hi]: tens of a map's
// thousands), so level 0 appends those t to a list in shared memory, in any
// order, and the later levels only compare the list against the new bound,
// whatever the segment count.  A beam with more than kCache candidates
// computes every pair anew in every later level.  The pack is read through
// the read-only cache: once a beam, 50 KB at 1800 segments, which
// neighbouring beams find in L1 or L2.
//
// The float minimum is exact and free of order, so a level equals the
// twin's amin in value whatever the order of the lanes or of the list.
// Where +0.0 and -0.0 both are candidates the sign of the zero returned may
// differ from the twin's (fminf and the order choose); as a bound both act
// alike.  A beam whose t_after is +inf (resolved, padding), or a pack with no
// segment, writes +inf in every level and reads no segment.
//
// Bound.  Operations: ~20 and two divisions per pair in level 0, a compare
// per candidate after; the device count is read on the device, so the launch
// never waits on the host.
//
// A pose batch folds into the beam axis (grid/raycast_fast.py::
// raycast_fast_batch): `tr` is a table of P translations and beam b reads
// row b / beams_per_pose, so a pose's beams are consecutive blocks.  One
// scan is the table of one row.  A beam's arithmetic does not depend on
// where its translation came from, so a batch equals its scans bit for bit.
//
// Built with -fmad=false and IEEE division (ops/_build.py): t and u must
// equal the twin's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // warps a beam
constexpr int kLanes = 32 * kWarps;
constexpr int kCache = 2048;  // candidates a beam keeps in shared memory
constexpr int kBatch = 4;  // pairs a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

struct Beam {
  float rayx, rayy, trx, try_, c1tr, lo, hi;
};

// t of the beam with segment j where the pair is a candidate whatever the
// bound, else +inf.  Pack rows used: ex ey p0x p0y c0p valid eps.
__device__ __forceinline__ float candidate(const float* __restrict__ pack,
                                           size_t S, int j, const Beam& b) {
  const float* p = pack + j;
  const float ex = __ldg(p), ey = __ldg(p + S);
  const float p0x = __ldg(p + 2 * S), p0y = __ldg(p + 3 * S);
  const float c0p = __ldg(p + 4 * S), valid = __ldg(p + 5 * S);
  const float eps = __ldg(p + 6 * S);
  const float denom = b.rayx * ey - b.rayy * ex;           // cross(ray, e)
  const float c1 = (b.rayx * p0y - b.rayy * p0x) - b.c1tr;  // cross(ray, p0-tr)
  const float c0 = c0p - (b.trx * ey - b.try_ * ex);        // cross(p0-tr, e)
  const bool ok_denom = fabsf(denom) > eps;
  const float safe = ok_denom ? denom : 1.0f;
  const float t = c0 / safe;
  const float u = -c1 / safe;
  const bool ok = valid > 0.0f && ok_denom && u >= 0.0f && u <= 1.0f &&
                  t >= b.lo && t <= b.hi;
  return ok ? t : INFINITY;
}

// The lane's earliest candidate t >= bound among the segments lane,
// lane + kLanes, ... below n, kBatch pairs in flight (their loads start
// together).  With kStore every candidate, whatever the bound, is appended
// to `kept` while there is room; `n_kept` counts them all.
template <bool kStore>
__device__ __forceinline__ float sweep(const float* __restrict__ pack,
                                       size_t S, const Beam& beam,
                                       float bound, int n, int lane,
                                       float* kept, int* n_kept) {
  float best = INFINITY;
  for (int j0 = lane; j0 < n; j0 += kLanes * kBatch) {
    float t[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int j = j0 + kLanes * q;
      // past the end: the last segment again, discarded (no branch around
      // the loads)
      const float c = candidate(pack, S, min(j, n - 1), beam);
      t[q] = j < n ? c : INFINITY;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (kStore && t[q] < INFINITY) {
        const int slot = atomicAdd(n_kept, 1);
        if (slot < kCache) kept[slot] = t[q];
      }
      if (t[q] >= bound && t[q] < best) best = t[q];
    }
  }
  return best;
}

__global__ void __launch_bounds__(kLanes)
    segment_min_kernel(const float* __restrict__ pack, int S,
                       const int* __restrict__ count,
                       const float* __restrict__ ray,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       const float* __restrict__ t_after,
                       const float* __restrict__ tr, float* __restrict__ out,
                       int levels, float cover, int beams_per_pose) {
  __shared__ float kept[kCache];
  __shared__ int n_kept;
  __shared__ float warp_best[2][kWarps];  // by the level's parity
  const int lane = threadIdx.x;  // of the beam's kLanes
  const int b = blockIdx.x;
  float* o = out + static_cast<size_t>(b) * levels;
  float bound = t_after[b];
  const int n = min(*count, S);

  // every branch below is uniform over the block: its threads share the
  // beam, the count and each level's minimum
  int k = 0;
  if (bound < INFINITY && n > 0) {
    Beam beam;
    beam.rayx = ray[2 * b];
    beam.rayy = ray[2 * b + 1];
    const float* origin = tr + 2 * (b / beams_per_pose);
    beam.trx = origin[0];
    beam.try_ = origin[1];
    beam.c1tr = beam.rayx * beam.try_ - beam.rayy * beam.trx;  // cross(ray, tr)
    beam.lo = lo[b];
    beam.hi = hi[b];
    if (lane == 0) n_kept = 0;
    __syncthreads();
    while (k < levels) {
      // level 0's barrier below stands between the list's writes and reads
      float best;
      if (k == 0) {
        best = sweep<true>(pack, S, beam, bound, n, lane, kept, &n_kept);
      } else if (n_kept <= kCache) {
        best = INFINITY;
        for (int j = lane; j < n_kept; j += kLanes) {
          const float t = kept[j];
          if (t >= bound && t < best) best = t;
        }
      } else {
        best = sweep<false>(pack, S, beam, bound, n, lane, kept, &n_kept);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        best = fminf(best, __shfl_xor_sync(kFull, best, d));
      if ((lane & 31) == 0) warp_best[k & 1][lane >> 5] = best;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        best = fminf(best, warp_best[k & 1][w]);
      if (lane == 0) o[k] = best;
      ++k;
      if (!(best < INFINITY)) break;  // no later level can find one
      bound = best + cover;
    }
  }
  if (lane == 0)
    for (; k < levels; ++k) o[k] = INFINITY;
}

}  // namespace

// pack [8, S] float32; count: one int32 (valid segments, first in the pack);
// ray [B, 2]; lo, hi, t_after [B]; tr [B / beams_per_pose, 2] (sensor
// translations in the pack's frame, a row for each pose); out [B, levels]
// float32.  All on the device, one launch on `stream` for every level.
// Returns the first cudaError_t.
extern "C" int segment_min_f32(const float* pack, int S, const int* count,
                               const float* ray, const float* lo,
                               const float* hi, const float* t_after,
                               const float* tr, float* out, int B,
                               int levels, float cover, int beams_per_pose,
                               void* stream) {
  if (B <= 0 || levels <= 0) return 0;
  if (beams_per_pose <= 0 || B % beams_per_pose != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segment_min_kernel<<<B, kLanes, 0, st>>>(pack, S, count, ray, lo, hi,
                                           t_after, tr, out, levels, cover,
                                           beams_per_pose);
  return static_cast<int>(cudaGetLastError());
}
