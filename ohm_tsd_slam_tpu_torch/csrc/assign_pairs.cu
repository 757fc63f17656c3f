// ICP's pair assignment on Hopper (sm_90a): one iteration's nearest model
// point of every scene point, the distance gate and the reciprocal rule.
//
// Replaces no TPU kernel: the JAX package leaves
// ohm_tsd_slam_tpu/registration/nn.py::assign_pairs_fused to XLA, which
// fuses its [S, M] distance matrix into a few passes.  The port's eager
// torch body (registration/nn.py::assign_pairs_plain, this kernel's twin)
// is some 40 kernels and a dozen passes over the [S, M] matrix per ICP
// iteration; this file does the same work in two launches (three in
// float64) and a memset, and never writes the matrix to memory.
//
// Contract (assign_pairs_plain, on the card, in every bit):
//   d2(s, m) = (|s|^2 + |m|^2) - 2 (s_x m_x + s_y m_y), each product and
//     sum rounded on its own as torch's separate kernels round them,
//     clamped at 0 (NaN kept), +inf where model_mask[m] is false;
//   best[s] = min_m d2(s, m), NaN if the row holds a NaN; idx[s] its first
//     index, M - 1 for a NaN row (where(d2 == best, iota, M).amin, clamped),
//     0 for a row of +inf;
//   pair_mask[s] = scene_mask[s] & isfinite(best[s]) & best[s] <= *gate
//     (no gate where the pointer is null: it is read on the device, so a
//     graph replay reads the iteration's own value);
//   with the reciprocal rule, a pair survives iff its (best, s) is the least
//     among the selected pairs of its column idx[s];
//   dist2[s] = scene_mask[s] ? best[s] : +inf; paired[s] = payload[idx[s]]
//     where pair_mask[s], zeros elsewhere.
//
// Design.  Launch 1 (rows): a warp a scene row, eight rows a block; the
// block stages the model (x, y, |m|^2, valid) in shared memory, 32 KB at a
// time, and each lane keeps the least (d2, index) of the columns it strides
// in increasing order, so a strict compare keeps the first index; a
// shuffle reduction picks the least value and, on a tie, the least index.
// A selected row then takes one 64-bit atomicMin on its column's key.  In
// float32 the key is (bits of best) << 32 | s: best is finite and >= 0, so
// its bits order as its value, and the least key is the twin's two
// scatter_reduce(amin) at once, whatever the order of the atomics.  In
// float64 the bits fill the key: a second launch (ties) takes an atomicMin
// of s among the rows whose best equals their column's least.  Launch 2
// (pairs): a thread a row compares its column's key with its own, writes
// the mask and gathers the payload.  The keys are set to all ones by a
// memset on the stream before launch 1 (a memset node in a graph); without
// the reciprocal rule launch 1 gathers the payload itself and there is no
// memset and no launch 2.
//
// Bound.  Operations: ~10 a pair, 1.17 M pairs at the scan's 1081 x 1081,
// ~0.2 us at the float32 rate; bytes: the two clouds, the masks and the
// outputs, ~60 KB.  Launches and the staging of the model are all its time.
//
// Built with -fmad=false (ops/_build.py); the arithmetic is written with
// the _rn intrinsics besides, so no product is fused into a sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // scene rows a block in launch 1
constexpr int kTileBytes = 32768;   // model staged in shared memory at once
constexpr int kPairThreads = 256;   // threads a block in launches 2 and ties
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// A selected row's key in its column: the least key wins the column.
__device__ __forceinline__ unsigned long long row_key(float best, int s) {
  return (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
         static_cast<unsigned>(s);
}
__device__ __forceinline__ unsigned long long row_key(double best, int) {
  return static_cast<unsigned long long>(__double_as_longlong(best));
}

// 16 bytes in float32, one 128-bit load from shared memory
template <typename T>
struct __align__(4 * sizeof(T)) ModelPoint {
  T x, y, m2;
  int valid;
};

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// (v, i) before (bv, bi): a NaN before every number (the first NaN kept),
// then the lesser value, then the lesser index.
template <typename T>
__device__ __forceinline__ bool before(T v, int i, T bv, int bi) {
  if (is_nan(bv)) return false;
  if (is_nan(v)) return true;
  return v < bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    assign_rows_kernel(const T* __restrict__ model,
                       const uint8_t* __restrict__ model_mask,
                       const T* __restrict__ scene,
                       const uint8_t* __restrict__ scene_mask, int S, int M,
                       const T* __restrict__ gate,
                       unsigned long long* __restrict__ col_key,
                       const T* __restrict__ payload, int K,
                       int* __restrict__ idx_out, T* __restrict__ dist2_out,
                       uint8_t* __restrict__ mask_out,
                       T* __restrict__ paired) {
  constexpr int kTile = kTileBytes / sizeof(ModelPoint<T>);
  __shared__ ModelPoint<T> tile[kTile];
  const T inf = static_cast<T>(INFINITY);
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool row = s < S;  // the same for the whole warp
  T sx = 0, sy = 0, s2 = 0;
  if (row) {
    sx = scene[2 * s];
    sy = scene[2 * s + 1];
    s2 = add_rn(mul_rn(sx, sx), mul_rn(sy, sy));
  }
  // the lane's least (d2, index); index M: no column seen yet
  T best = inf;
  int bi = M;
  for (int c0 = 0; c0 < M; c0 += kTile) {
    const int n = min(kTile, M - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const T mx = model[2 * (c0 + j)], my = model[2 * (c0 + j) + 1];
      tile[j] = {mx, my, add_rn(mul_rn(mx, mx), mul_rn(my, my)),
                 model_mask[c0 + j]};
    }
    __syncthreads();
    if (!row) continue;
    for (int j = lane; j < n; j += 32) {
      const ModelPoint<T> m = tile[j];
      const T cross = add_rn(mul_rn(sx, m.x), mul_rn(sy, m.y));
      T d = sub_rn(add_rn(s2, m.m2), mul_rn(static_cast<T>(2), cross));
      d = d < static_cast<T>(0) ? static_cast<T>(0) : d;  // NaN stays
      d = m.valid ? d : inf;
      // columns come in increasing order: the first of equal values stays
      // (the first +inf where nothing is less)
      if (is_nan(d) ? !is_nan(best) : (d < best || bi == M)) {
        best = d;
        bi = c0 + j;
      }
    }
  }
  if (!row) return;
  for (int off = 16; off; off >>= 1) {
    const T ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (before(ob, oi, best, bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (is_nan(best)) bi = M - 1;  // no d2 equals a NaN: the twin's clamp
  const bool in_scene = scene_mask[s] != 0;
  const bool pm = in_scene && isfinite(best) && (!gate || best <= *gate);
  if (lane == 0) {
    idx_out[s] = bi;
    dist2_out[s] = in_scene ? best : inf;
    mask_out[s] = pm;
    if (col_key && pm) atomicMin(col_key + bi, row_key(best, s));
  }
  if (!col_key) {
    for (int k = lane; k < K; k += 32)
      paired[static_cast<size_t>(s) * K + k] =
          pm ? payload[static_cast<size_t>(bi) * K + k] : static_cast<T>(0);
  }
}

// float64: the least scene index among the selected rows whose best equals
// their column's least best.
__global__ void assign_ties_kernel(const double* __restrict__ dist2,
                                   const int* __restrict__ idx,
                                   const uint8_t* __restrict__ mask, int S,
                                   const unsigned long long* __restrict__ key,
                                   unsigned* __restrict__ first) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S || !mask[s]) return;
  const int c = idx[s];
  if (key[c] == row_key(dist2[s], s)) atomicMin(first + c, unsigned(s));
}

template <typename T>
__global__ void assign_pairs_kernel(const T* __restrict__ dist2,
                                    const int* __restrict__ idx,
                                    uint8_t* __restrict__ mask, int S,
                                    const unsigned long long* __restrict__ key,
                                    const unsigned* __restrict__ first,
                                    const T* __restrict__ payload, int K,
                                    T* __restrict__ paired) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int c = idx[s];
  // a selected row's dist2 is its best (its scene mask is set)
  const bool keep = mask[s] && key[c] == row_key(dist2[s], s) &&
                    (!first || first[c] == unsigned(s));
  mask[s] = keep;
  for (int k = 0; k < K; ++k)
    paired[static_cast<size_t>(s) * K + k] =
        keep ? payload[static_cast<size_t>(c) * K + k] : static_cast<T>(0);
}

template <typename T>
int run(const T* model, const uint8_t* model_mask, const T* scene,
        const uint8_t* scene_mask, const T* payload, int K, int S, int M,
        const T* gate, void* work, int* idx, T* dist2, uint8_t* pair_mask,
        T* paired, cudaStream_t stream) {
  auto* key = static_cast<unsigned long long*>(work);
  // float64 keeps the ties' least scene index after the M keys
  unsigned* first = (work && sizeof(T) == 8)
                        ? reinterpret_cast<unsigned*>(key + M)
                        : nullptr;
  if (work) {
    const size_t bytes = M * (sizeof(*key) + (first ? sizeof(*first) : 0));
    cudaError_t err = cudaMemsetAsync(work, 0xff, bytes, stream);
    if (err != cudaSuccess) return err;
  }
  assign_rows_kernel<T><<<(S + kWarps - 1) / kWarps, kWarps * 32, 0,
                          stream>>>(model, model_mask, scene, scene_mask, S,
                                    M, gate, key, payload, K, idx, dist2,
                                    pair_mask, paired);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !work) return err;
  const int blocks = (S + kPairThreads - 1) / kPairThreads;
  if (first) {
    assign_ties_kernel<<<blocks, kPairThreads, 0, stream>>>(
        reinterpret_cast<const double*>(dist2), idx, pair_mask, S, key,
        first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  assign_pairs_kernel<T><<<blocks, kPairThreads, 0, stream>>>(
      dist2, idx, pair_mask, S, key, first, payload, K, paired);
  return cudaGetLastError();
}

}  // namespace

// model [M, 2], model_mask [M], scene [S, 2], scene_mask [S], payload
// [M, K], all contiguous on one card; gate: one value or null (no gate);
// work: M * 8 bytes (float32) or M * 12 (float64) of scratch, or null for
// no reciprocal rule.  Outputs idx [S] int32, dist2 [S], pair_mask [S]
// (bool bytes), paired [S, K].  Launches on `stream`, returns the CUDA
// error of the memset and the launches (0 on success).
extern "C" int assign_pairs_f32(const float* model, const uint8_t* model_mask,
                                const float* scene,
                                const uint8_t* scene_mask,
                                const float* payload, int K, int S, int M,
                                const float* gate, void* work, int* idx,
                                float* dist2, uint8_t* pair_mask,
                                float* paired, cudaStream_t stream) {
  return run<float>(model, model_mask, scene, scene_mask, payload, K, S, M,
                    gate, work, idx, dist2, pair_mask, paired, stream);
}

extern "C" int assign_pairs_f64(const double* model,
                                const uint8_t* model_mask,
                                const double* scene,
                                const uint8_t* scene_mask,
                                const double* payload, int K, int S, int M,
                                const double* gate, void* work, int* idx,
                                double* dist2, uint8_t* pair_mask,
                                double* paired, cudaStream_t stream) {
  return run<double>(model, model_mask, scene, scene_mask, payload, K, S, M,
                     gate, work, idx, dist2, pair_mask, paired, stream);
}
