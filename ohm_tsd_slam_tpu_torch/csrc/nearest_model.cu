// EXP's nearest model point on Hopper (sm_90a): for every control point of
// every candidate transform that registration/ransac.py::match_normal
// scores (RandomNormalMatching, registration mode 1), the nearest valid
// model point and that point's normal.
//
// Replaces no TPU kernel: the JAX package leaves match_normal to XLA, which
// fuses its [chunk, C, N] distance tensor away.  The port's torch body
// (registration/ransac.py::nearest_model_plain, this kernel's twin) builds
// that tensor for real, [256, 180, 1081] float32 (199 MB) a chunk and 94
// chunks a scan at the published widths, and takes its minimum and payload
// in some five passes over it; this kernel never writes it.
//
// Contract (nearest_model_plain on the card, in every bit, on every query
// the kernel computes):
//   d2(k, c, m) = (q2[k, c] + msq[m]) - 2 (st[k, c, 0] mx[m] + st[k, c, 1]
//     my[m]), each product and sum rounded on its own as torch's separate
//     kernels round them;
//   d2min[k, c] = max(min_m d2, 0); idx[k, c] its first index m (a strict
//     compare over m in increasing order, as torch.min documents);
//     cos_nn[k, c] = cosm[idx], sin_nn[k, c] = sinm[idx].
//   st and q2 are the caller's, as torch computed them (the transform, its
//   square and every transcendental stay in torch); msq[m] is |m|^2, plus
//   _BIG (1e9) where the model point is masked, as the twin takes it.  The
//   kernel walks every model point in increasing index, masked ones too,
//   so it takes the twin's minimum by construction, also where no model
//   point is valid.
//   The queries of a candidate with valid[k] false are not computed (their
//   scores never reach a qualified winner: its ratio is -_BIG): d2min +inf,
//   idx -1, cos_nn = sin_nn = 0 there.  The inputs are finite: a NaN
//   distance would never be taken, where torch's min returns it.
//   The doubled cross term is subtracted by one fused multiply-add with -2:
//   the doubling is exact, so fma(-2, cross, a) rounds a - 2 cross once,
//   as torch's separate multiply and subtract do (for |cross| below 1e38).
//
// Design.  A warp a candidate, eight candidates a block; a lane holds R
// control points (c = lane + 32 r, R = ceil(C / 32) up to 8, a template
// argument, so the loop is unrolled and the rows live in registers).  A
// block in which no candidate is valid writes the skipped values and ends.
// Otherwise it stages the model points (x, y, msq: 16 bytes with a pad in
// float32) in shared memory, 2048 at a time (1024 in float64), and every
// lane of a valid candidate walks them, each point read once as a
// broadcast and tested against its R control points; the index is the
// loop's.  In float64 the same template runs in double throughout (32
// bytes a staged point; the scan's 1081 points in two windows).
//
// Bound.  Operations: 8 a (query, model point) pair (two products, two
// sums, the fused multiply-add, the compare and two selects), each issued
// on its own (-fmad=false), so about half of the float32 rate, which
// counts a fused multiply-add as two, is the ceiling.  At the published
// widths up to 24,000 x 180 x 1081 = 4.7e9 pairs, of which the valid
// candidates (trials whose scene beam survives the subsample and turns by
// less than 30 degrees) are a small share.  Bytes: st, q2 and the four
// [K, C] outputs, ~100 MB, 0.03 ms.
//
// Built with -fmad=false (ops/_build.py); the arithmetic is written with
// the _rn intrinsics besides.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // candidates a block
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 32768;   // model points staged at once
constexpr int kMaxRows = 8;         // control points a lane, C <= 256 a pass

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// 16 bytes in float32
template <typename T>
struct __align__(4 * sizeof(T)) ModelPoint {
  T x, y, m2, pad;
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    nearest_model_kernel(const T* __restrict__ st, const T* __restrict__ q2,
                         const uint8_t* __restrict__ valid, int K, int C,
                         const T* __restrict__ model,
                         const T* __restrict__ msq, int M,
                         const T* __restrict__ cosm,
                         const T* __restrict__ sinm, T* __restrict__ d2min,
                         int* __restrict__ idx_out, T* __restrict__ cos_nn,
                         T* __restrict__ sin_nn) {
  constexpr int kTile = kTileBytes / sizeof(ModelPoint<T>);
  __shared__ ModelPoint<T> tile[kTile];
  const T inf = static_cast<T>(INFINITY);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  const bool live = k < K && valid[k];
  const bool any_live = __syncthreads_or(live);
  for (int c0 = 0; c0 < C; c0 += 32 * R) {
    T sx[R], sy[R], qq[R], best[R];
    int bi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = c0 + 32 * r + lane;
      const bool in = live && c < C;
      const size_t q = static_cast<size_t>(k) * C + c;
      sx[r] = in ? st[2 * q] : static_cast<T>(0);
      sy[r] = in ? st[2 * q + 1] : static_cast<T>(0);
      qq[r] = in ? q2[q] : static_cast<T>(0);
      best[r] = inf;
      bi[r] = -1;
    }
    for (int m0 = 0; any_live && m0 < M; m0 += kTile) {
      const int n = min(M - m0, kTile);
      __syncthreads();  // the last window's readers are done with the tile
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const int m = m0 + j;
        tile[j] = {model[2 * m], model[2 * m + 1], msq[m],
                   static_cast<T>(0)};
      }
      __syncthreads();
      if (!live) continue;
      // not unrolled: unrolled by 2 or by the compiler's choice, ptxas
      // spills some row counts (float32 R = 1, float64 R = 5 on sm_90a)
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const T px = tile[i].x, py = tile[i].y, pm = tile[i].m2;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T cross = add_rn(mul_rn(sx[r], px), mul_rn(sy[r], py));
          const T d = fma_rn(static_cast<T>(-2), cross, add_rn(qq[r], pm));
          if (d < best[r]) {  // strict: the first of equal values stays
            best[r] = d;
            bi[r] = m0 + i;
          }
        }
      }
    }
    if (k >= K) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = c0 + 32 * r + lane;
      if (c >= C) continue;
      const size_t q = static_cast<size_t>(k) * C + c;
      const bool hit = live && bi[r] >= 0;
      d2min[q] = hit ? (best[r] < static_cast<T>(0) ? static_cast<T>(0)
                                                     : best[r])
                     : inf;
      idx_out[q] = hit ? bi[r] : -1;
      cos_nn[q] = hit ? cosm[bi[r]] : static_cast<T>(0);
      sin_nn[q] = hit ? sinm[bi[r]] : static_cast<T>(0);
    }
  }
}

template <typename T, int R>
cudaError_t launch(const T* st, const T* q2, const uint8_t* valid, int K,
                   int C, const T* model, const T* msq, int M, const T* cosm,
                   const T* sinm, T* d2min, int* idx, T* cos_nn, T* sin_nn,
                   cudaStream_t stream) {
  const int blocks = (K + kWarps - 1) / kWarps;
  nearest_model_kernel<T, R><<<blocks, kThreads, 0, stream>>>(
      st, q2, valid, K, C, model, msq, M, cosm, sinm, d2min, idx, cos_nn,
      sin_nn);
  return cudaGetLastError();
}

template <typename T>
int run(const T* st, const T* q2, const uint8_t* valid, int K, int C,
        const T* model, const T* msq, int M, const T* cosm, const T* sinm,
        T* d2min, int* idx, T* cos_nn, T* sin_nn, cudaStream_t stream) {
  // rows a lane: ceil(C / 32), at most kMaxRows (more passes past 256)
  const int rows = min(kMaxRows, (C + 31) / 32);
#define NEAREST_MODEL_ROWS(R)                                            \
  case R:                                                                \
    return launch<T, R>(st, q2, valid, K, C, model, msq, M, cosm, sinm,  \
                        d2min, idx, cos_nn, sin_nn, stream);
  switch (rows) {
    NEAREST_MODEL_ROWS(1)
    NEAREST_MODEL_ROWS(2)
    NEAREST_MODEL_ROWS(3)
    NEAREST_MODEL_ROWS(4)
    NEAREST_MODEL_ROWS(5)
    NEAREST_MODEL_ROWS(6)
    NEAREST_MODEL_ROWS(7)
    NEAREST_MODEL_ROWS(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef NEAREST_MODEL_ROWS
}

}  // namespace

// st [K, C, 2], q2 [K, C], valid [K] (bool bytes), model [M, 2], msq [M],
// cosm [M], sinm [M], all contiguous on one card, K, C and M at least 1.
// Outputs d2min [K, C], idx [K, C] int32, cos_nn [K, C], sin_nn [K, C].
// Launches on `stream`, returns the CUDA error of the launch (0 on
// success).
extern "C" int nearest_model_f32(const float* st, const float* q2,
                                 const uint8_t* valid, int K, int C,
                                 const float* model, const float* msq, int M,
                                 const float* cosm, const float* sinm,
                                 float* d2min, int* idx, float* cos_nn,
                                 float* sin_nn, cudaStream_t stream) {
  return run<float>(st, q2, valid, K, C, model, msq, M, cosm, sinm, d2min,
                    idx, cos_nn, sin_nn, stream);
}

extern "C" int nearest_model_f64(const double* st, const double* q2,
                                 const uint8_t* valid, int K, int C,
                                 const double* model, const double* msq,
                                 int M, const double* cosm,
                                 const double* sinm, double* d2min, int* idx,
                                 double* cos_nn, double* sin_nn,
                                 cudaStream_t stream) {
  return run<double>(st, q2, valid, K, C, model, msq, M, cosm, sinm, d2min,
                     idx, cos_nn, sin_nn, stream);
}
