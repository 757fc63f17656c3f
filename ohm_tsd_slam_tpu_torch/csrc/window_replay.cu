// Exact-march window replay with crossing normals on Hopper (sm_90a): round
// 1 for every beam (window_replay_f32) and rounds 2..ROUNDS in one launch
// (window_rounds_f32).
//
// Replaces the TPU kernels ohm_tsd_slam_tpu/ops/window_block_pallas.py::
// window_block_pallas (blocks of 16 beams sharing one patch; here round 1)
// and window_single_pallas (one patch per beam, for deferred beams and
// rounds 2..4; here the rounds).  Contract of one replay
// (grid/raycast_fast.py::window_replay_plain): per active beam, the march of
// RayCastPolar2D.cpp:237-270 over WINDOW = 8 samples t = tw0 + j from
// tw0 = idx_min + max(floor(k - idx_min) - BACKOFF, 0) for the candidate k:
// bilinear taps in interpolate_bilinear's summation order (out-of-grid taps
// read NaN), +→− a hit, −→+ a back face, NaN samples invalid, sample pairs
// only while t - 1 <= idx_max; then the sub-cell interpolation of the first
// event and the central-difference normal there
// (grid/interpolate.py::interpolate_normal).  A row is hit, any_ev, pos_x,
// pos_y, interp, nx, ny, n_ok; zeros for an inactive beam.
//
// Design.  A beam's 8 samples go to 8 neighbouring lanes (4 beams a warp):
// each lane takes its sample's 4 taps straight from the field in global
// memory, so a beam's 32 loads are in flight at once and 1081 beams fill 68
// blocks of 128 threads.  The first event is a ballot over the lane group;
// the pair's samples and position come by shuffle, so no array is indexed
// at run time and nothing spills to a stack frame.  Lanes 0..3 take the four
// normal taps, and lane j stores column j of the row: a warp writes 128
// contiguous bytes.  The patches, their fit test and the defer pass of the
// Pallas kernels work around the TPU's slow gathers and have no counterpart
// here.  The tile-initialization check of interpolate_bilinear is left out:
// a cell of a never-initialized tile is NaN in the dense field (the push
// writes only tiles it touches, and initializes them), so its blend is NaN
// all the same.
//
// The rounds (grid/raycast_fast.py::window_rounds_plain): a beam's rank
// among the beams that need a round counts every lower beam, because the
// first `cap` needing beams in beam order are replayed and the rest are
// dropped (the twin's compact_mask); and round r + 1 reads round r's
// resolved flags of every beam.  So each round lists by a prefix sum, not an
// atomic append, and the rounds are separated by barriers over every
// thread that takes part.  Per round the threads stride the beams, scan
// `need` (a ballot per warp, the warps' counts through shared memory, a
// running total across strides), list the first `cap` needing beams and mark
// the others resolved; then the lane groups replay the listed beams and
// overwrite, in place, the rows of those that found an event.  No compaction
// arrays, no gather, no scatter.
//
// Up to ops/window_replay_cuda.py::ONE_BLOCK_BEAMS beams (a scan, or a few
// robots' scans) this is one block: the list lies in shared memory and the
// barriers are __syncthreads.  A pose batch folded into the beam axis (128
// scans are 138,368 beams: 136 strides a round on one SM) takes a
// cooperative launch of a block a 1024 beams, at most as many as are
// resident at once, each owning a consecutive chunk of beams: a block
// counts its chunk's needing beams, a grid barrier,
// each block adds the counts of the blocks before it (the exclusive prefix
// over chunks, so ranks stay in beam order), lists its chunk from there into
// a list in global memory, a grid barrier, the blocks share out the listed
// replays, a grid barrier.  Three grid barriers a round, one launch a call.
//
// A pose batch gives each pose its own sensor translation: `tr` is a table
// of P rows and beam b reads row b / beams_per_pose (sensor_origin).
//
// Round 1 also replays on a row block of the grid (the halo'd block of a
// row-sharded rank, parallel/shard_raycast.py): the field's row 0 is world
// row `row0`, the base cell must lie in the block's world rows [row0,
// row0 + H) and a tap past the block reads NaN, as past the grid.  With
// row0 = 0 every operation is the whole grid's.
//
// Bound.  Latency: 32 tap loads a beam from L2, then 16 for the normal.
//
// Built with -fmad=false and IEEE division and sqrt (ops/_build.py): the
// samples, and so the events, must equal the twin's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWindow = 8;         // grid/raycast_fast.py::WINDOW
constexpr float kBackoff = 2.0f;   // grid/raycast_fast.py::BACKOFF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRoundsThreads = 1024;

// The field: H rows of W cells whose row 0 is world row row0 (0 for the
// whole grid; a row-sharded rank's halo block starts below its rows,
// parallel/shard_raycast.py).  Cells and weights come from the world
// coordinates; a tap at world row iy reads the field's row iy - row0.
struct Field {
  const float* tsd;
  int H, W;
  float s;
  int row0;
};

// the cell at column ix of world row iy (iy >= row0): NaN past the field
__device__ __forceinline__ float cell(const Field& g, int ix, int iy) {
  const int by = iy - g.row0;
  return (ix < g.W && by < g.H) ? g.tsd[static_cast<long>(by) * g.W + ix]
                                : NAN;
}

// interpolate_bilinear at world (px, py): NaN when the base cell is off the
// field or a tap is NaN or off the field
__device__ __forceinline__ float bilinear(const Field& g, float px,
                                          float py) {
  const float u = px / g.s - 0.5f;
  const float v = py / g.s - 0.5f;
  const float fx = floorf(u);
  const float fy = floorf(v);
  if (!(fx >= 0.0f && fx < g.W && fy >= static_cast<float>(g.row0) &&
        fy < static_cast<float>(g.row0 + g.H)))
    return NAN;
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

// the sensor translation of `beam` (world frame): row beam / beams_per_pose
// of the table (one row for all beams of a scan)
__device__ __forceinline__ float2 sensor_origin(const float* __restrict__ tr,
                                                int beam,
                                                int beams_per_pose) {
  const float* o = tr + 2 * (beam / beams_per_pose);
  return make_float2(o[0], o[1]);
}

// column j of a beam's row, and whether the window held an event
struct Column {
  float value;
  bool any_ev;
};

// One beam's replay by its group of 8 lanes (lane j of the group takes
// sample j).  Every lane of the warp must call it, active or not: the
// ballot and the shuffles are warp-wide.  Every lane of the group gets its
// column of the row; an inactive group's values are meaningless.
__device__ __forceinline__ Column replay_column(const Field& g, bool active,
                                                float k, float idx_min,
                                                float idx_max, float rx,
                                                float ry, float2 tr, int j) {
  const int lane = threadIdx.x & 31;
  const int group = lane & ~(kWindow - 1);

  // this lane's sample and the next sample's step
  const float t0 = idx_min + fmaxf(floorf(k - idx_min) - kBackoff, 0.0f);
  const float t = t0 + static_cast<float>(j);
  const float t_next = t0 + static_cast<float>(j + 1);
  const float px = tr.x + t * rx;
  const float py = tr.y + t * ry;
  const float v = active ? bilinear(g, px, py) : NAN;

  // first event among the sample pairs (j, j+1); lane 7 has no pair
  const float v_next = __shfl_down_sync(kFull, v, 1, kWindow);
  const bool ok = j < kWindow - 1 && (t_next - 1.0f) <= idx_max;
  const bool ev_pos = v > 0.0f && v_next < 0.0f && ok;
  const bool ev_neg = v < 0.0f && v_next > 0.0f && ok;
  const unsigned ev =
      (__ballot_sync(kFull, ev_pos || ev_neg) >> group) & 0xffu;
  const unsigned pos = (__ballot_sync(kFull, ev_pos) >> group) & 0xffu;
  const bool any_ev = ev != 0u;
  const int e = any_ev ? __ffs(ev) - 1 : 0;  // as the twin: the first pair
  const bool hit = (pos >> e) & 1u;
  const float vp = __shfl_sync(kFull, v, e, kWindow);
  const float vc = __shfl_sync(kFull, v, e + 1, kWindow);
  const float pos_x = __shfl_sync(kFull, px, e + 1, kWindow);
  const float pos_y = __shfl_sync(kFull, py, e + 1, kWindow);
  const float interp = vp / (vp - vc);

  // crossing point and its central-difference normal: lanes 0..3 take the
  // taps at +x, -x, +y, -y
  const float cx = pos_x + rx * (interp - 1.0f);
  const float cy = pos_y + ry * (interp - 1.0f);
  float qx = cx, qy = cy;
  if (j == 0) qx = cx + g.s;
  if (j == 1) qx = cx - g.s;
  if (j == 2) qy = cy + g.s;
  if (j == 3) qy = cy - g.s;
  const float tap = (active && j < 4) ? bilinear(g, qx, qy) : NAN;
  const float xp = __shfl_sync(kFull, tap, 0, kWindow);
  const float xm = __shfl_sync(kFull, tap, 1, kWindow);
  const float yp = __shfl_sync(kFull, tap, 2, kWindow);
  const float ym = __shfl_sync(kFull, tap, 3, kWindow);
  const bool n_ok = !(isnan(xp) || isnan(xm) || isnan(yp) || isnan(ym));
  const float nx = xp - xm;
  const float ny = yp - ym;
  const float norm = sqrtf(nx * nx + ny * ny);
  const float den = norm > 0.0f ? norm : 1.0f;

  float col = n_ok ? 1.0f : 0.0f;                      // 7: n_ok
  if (j == 0) col = (any_ev && hit) ? 1.0f : 0.0f;     // hit
  if (j == 1) col = any_ev ? 1.0f : 0.0f;              // any_ev
  if (j == 2) col = pos_x;
  if (j == 3) col = pos_y;
  if (j == 4) col = interp;
  if (j == 5) col = n_ok ? nx / den : NAN;
  if (j == 6) col = n_ok ? ny / den : NAN;
  return Column{col, any_ev};
}

__global__ void window_replay_kernel(Field g, const float* __restrict__ k,
                                     const float* __restrict__ ray,
                                     const float* __restrict__ idx_min,
                                     const float* __restrict__ idx_max,
                                     const bool* __restrict__ active,
                                     const float* __restrict__ tr,
                                     float* __restrict__ out, int N,
                                     int beams_per_pose) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int beam = gid / kWindow;
  const int j = gid % kWindow;
  const bool in_range = beam < N;
  const int b = in_range ? beam : 0;
  const bool act = in_range && active[b];
  const Column col =
      replay_column(g, act, k[b], idx_min[b], idx_max[b], ray[2 * b],
                    ray[2 * b + 1], sensor_origin(tr, b, beams_per_pose), j);
  if (in_range) out[static_cast<long>(gid)] = act ? col.value : 0.0f;
}

// The sum over the block of every thread's `v`, in every thread.  `scratch`
// holds a word a warp; the call begins and ends with a barrier, so the
// scratch may be used again at once.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int sum = 0;
  for (int w = 0; w < kRoundsThreads / 32; ++w) sum += scratch[w];
  __syncthreads();
  return sum;
}

// Whether beam b needs round r: a finite candidate and not resolved.  S is
// written during the launch (by other blocks too), so it is read through a
// plain pointer: a const __restrict__ one would let the compiler read it
// through the non-coherent read-only cache.
__device__ __forceinline__ bool needs_round(const float* S,
                                            const float* __restrict__ lev,
                                            int b, int r, int lev_stride) {
  return isfinite(lev[static_cast<long>(b) * lev_stride + r]) &&
         !(S[static_cast<long>(b) * 8 + 1] > 0.0f);
}

// Rounds 2..ROUNDS on the per-beam state S [N, 8], in place.  lev
// [N, n_rounds] with `lev_stride` floats between beams: round r's candidate
// per beam (inf = none).  One block, or (gridDim.x > 1) a cooperative launch
// whose block k owns beams [k * chunk, (k + 1) * chunk); `scratch` then
// holds the list [cap] and a count a block.
__global__ void __launch_bounds__(kRoundsThreads)
    window_rounds_kernel(Field g, float* S, const float* __restrict__ lev,
                         const float* __restrict__ ray,
                         const float* __restrict__ idx_min,
                         const float* __restrict__ idx_max,
                         const float* __restrict__ tr, int N, int n_rounds,
                         int lev_stride, int cap, int beams_per_pose,
                         int chunk, int* scratch,
                         long long* __restrict__ dropped_out) {
  extern __shared__ int shared_list[];     // [cap] in one block
  __shared__ int warp_count[kRoundsThreads / 32];
  const bool grid_wide = gridDim.x > 1;    // uniform over the launch
  int* listed = grid_wide ? scratch : shared_list;
  int* block_count = scratch + cap;        // grid-wide only
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b_begin = blockIdx.x * chunk;
  const int b_end = min(N, b_begin + chunk);
  int dropped = 0;                         // the same in every thread

  for (int r = 0; r < n_rounds; ++r) {
    // ---- the needing beams before this block's chunk, and in all ----
    int total = 0;                         // needing beams below the stride
    int total_all = 0;
    if (grid_wide) {
      int mine = 0;
      for (int b = b_begin + tid; b < b_end; b += kRoundsThreads)
        mine += needs_round(S, lev, b, r, lev_stride);
      mine = block_sum(mine, warp_count);
      if (tid == 0) block_count[blockIdx.x] = mine;
      cg::this_grid().sync();
      int before = 0, all = 0;
      for (int k = tid; k < gridDim.x; k += kRoundsThreads) {
        const int c = block_count[k];
        all += c;
        if (k < blockIdx.x) before += c;
      }
      total = block_sum(before, warp_count);
      total_all = block_sum(all, warp_count);
    }

    // ---- which beams of the chunk need this round, and their rank ----
    for (int b0 = b_begin; b0 < b_end; b0 += kRoundsThreads) {
      const int b = b0 + tid;
      bool need = false;
      if (b < b_end) {
        need = needs_round(S, lev, b, r, lev_stride);
        // a beam that does not need the round is resolved from here on
        if (!need)
          S[static_cast<long>(b) * 8 + 1] =
              fmaxf(S[static_cast<long>(b) * 8 + 1], 1.0f);
      }
      const unsigned bal = __ballot_sync(kFull, need);
      if (lane == 0) warp_count[warp] = __popc(bal);
      __syncthreads();
      int rank = total + __popc(bal & ((1u << lane) - 1u));
      int stride_count = 0;
      for (int w = 0; w < kRoundsThreads / 32; ++w) {
        const int c = warp_count[w];
        if (w < warp) rank += c;
        stride_count += c;
      }
      if (need && rank < cap) listed[rank] = b;
      total += stride_count;
      __syncthreads();                     // warp_count is reused
    }
    if (!grid_wide) total_all = total;
    const int n_listed = min(total_all, cap);
    dropped += max(total_all - cap, 0);
    if (grid_wide) cg::this_grid().sync();  // the list, before the replays

    // ---- replay the listed beams, 8 lanes a beam ----
    constexpr int kSlots = kRoundsThreads / kWindow;  // beams a block a pass
    for (int e0 = blockIdx.x * kSlots; e0 < n_listed;
         e0 += gridDim.x * kSlots) {
      const int e = e0 + tid / kWindow;
      const int j = tid % kWindow;
      const bool act = e < n_listed;
      const int b = act ? listed[e] : 0;
      const Column col = replay_column(
          g, act, lev[static_cast<long>(b) * lev_stride + r], idx_min[b],
          idx_max[b], ray[2 * b], ray[2 * b + 1],
          sensor_origin(tr, b, beams_per_pose), j);
      if (act && col.any_ev) S[static_cast<long>(b) * 8 + j] = col.value;
    }
    // the rows, before the next round's scan
    if (grid_wide)
      cg::this_grid().sync();
    else
      __syncthreads();
  }
  if (blockIdx.x == 0 && tid == 0) *dropped_out = dropped;  // <= N a round
}

}  // namespace

// Round 1.  tsd [H, W] float32 whose row 0 is world row row0 (0: the
// whole grid); k (the candidate step), idx_min, idx_max [N]; ray [N, 2];
// active [N] bool; tr [N / beams_per_pose, 2] (sensor translations, world
// frame, a row a pose); out [N, 8] float32.  All on the device, launched
// on `stream`.  Returns the cudaError_t of the launch.
extern "C" int window_replay_f32(const float* tsd, int H, int W, int row0,
                                 float s,
                                 const float* k, const float* ray,
                                 const float* idx_min, const float* idx_max,
                                 const bool* active, const float* tr,
                                 float* out, int N, int beams_per_pose,
                                 void* stream) {
  if (beams_per_pose <= 0 || N % beams_per_pose != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Field g{tsd, H, W, s, row0};
  constexpr int kThreads = 128;
  const long threads = static_cast<long>(N) * kWindow;
  window_replay_kernel<<<static_cast<unsigned>((threads + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, k, ray, idx_min, idx_max, active, tr, out, N, beams_per_pose);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the rounds kernel the current card holds at once (a
// cooperative launch may take no more).  Negative: the cudaError_t of the
// query.
extern "C" int window_rounds_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_rounds_kernel, kRoundsThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

// Rounds 2..ROUNDS.  S [N, 8] float32, updated in place; lev [N, n_rounds]
// float32, a beam's rounds adjacent and `lev_stride` floats from one beam to
// the next (the later columns of the candidate sweep's levels are taken as
// they lie); ray, idx_min, idx_max, tr, beams_per_pose as above; cap
// replays a round at most; `blocks` (ops/window_replay_cuda.py::
// window_rounds_blocks, at most window_rounds_resident_blocks()): with one,
// the list lies in cap * 4 bytes of shared memory (at most 48 KB) and
// `scratch` is not read; with more, scratch holds cap + blocks int32 and
// the launch is cooperative.  dropped_out one int64: the needing beams
// beyond cap, summed over the rounds.  Returns the cudaError_t of the
// launch.
extern "C" int window_rounds_f32(const float* tsd, int H, int W, float s,
                                 float* S, const float* lev,
                                 const float* ray, const float* idx_min,
                                 const float* idx_max, const float* tr,
                                 int N, int n_rounds, int lev_stride,
                                 int cap, int beams_per_pose, int blocks,
                                 int* scratch, long long* dropped_out,
                                 void* stream) {
  if (beams_per_pose <= 0 || N % beams_per_pose != 0 || blocks < 1 ||
      (blocks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Field g{tsd, H, W, s, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk = (N + blocks - 1) / blocks;
  if (blocks == 1) {
    window_rounds_kernel<<<1, kRoundsThreads, cap * sizeof(int), st>>>(
        g, S, lev, ray, idx_min, idx_max, tr, N, n_rounds, lev_stride, cap,
        beams_per_pose, chunk, scratch, dropped_out);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&g,      &S,   &lev,        &ray, &idx_min,
                  &idx_max, &tr, &N,          &n_rounds, &lev_stride,
                  &cap,    &beams_per_pose,   &chunk, &scratch,
                  &dropped_out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(window_rounds_kernel), dim3(blocks),
      dim3(kRoundsThreads), args, 0, st));
}
