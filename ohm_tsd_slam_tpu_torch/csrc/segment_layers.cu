// Marching-squares segment layers of a float32 TSD field on Hopper (sm_90a).
//
// Replaces the TPU kernel
// ohm_tsd_slam_tpu/ops/segment_layers_pallas.py::segment_layers_pallas.
// Its contract is the mask of grid/raycast_fast.py::_segment_layers, exactly:
// a [4, H, W] float32 0/1 mask, layer-major (0 marching-squares segment 1,
// 1 the saddle's segment 2, 2 virtual h-edge, 3 virtual v-edge), plus the
// count of set lanes of every 128-lane row of the flat mask (int32, one
// per row of 128 cells of one layer).
//
// Design.  One block of 128 threads per 128 cells of one grid row; each
// thread evaluates the quad (y, x) once and the neighbouring quads
// (y-1, x) and (y, x-1) that the virtual layers' suppression test needs,
// reading the field from global memory (the three rows a block touches
// sit in L1/L2).  __syncthreads_count gives each layer's row count.  The
// Pallas kernel's VMEM-resident field and its row-block grid exist for the
// TPU's memory; nothing carries over between blocks here.
//
// Bound.  Bytes: the field is read about three times through L1/L2 (4 MB
// at 1024^2) and the mask written once (16 MB): ~6 us of HBM at 3.35 TB/s.
//
// The mask is a set of float comparisons only, so no rounding question
// arises; the build keeps the caster's IEEE flags all the same
// (ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRow = 128;  // lanes per counted row (ops/compact_pallas CHUNK)

__device__ __forceinline__ bool crossing(float a, float b) {
  return (a > 0.0f && b < 0.0f) || (a < 0.0f && b > 0.0f);
}

struct Quad {
  bool ok;  // all four corners finite
  int n;    // crossed edges (of a quad with finite corners)
};

// quad (y, x) with corners (y,x), (y,x+1), (y+1,x+1), (y+1,x); callers
// check 0 <= y < H-1, 0 <= x < W-1
__device__ __forceinline__ Quad quad(const float* __restrict__ tsd, int W,
                                     int y, int x) {
  const float* r0 = tsd + static_cast<long>(y) * W + x;
  const float* r1 = r0 + W;
  const float v00 = r0[0], v01 = r0[1], v10 = r1[0], v11 = r1[1];
  Quad q;
  q.ok = !(isnan(v00) || isnan(v01) || isnan(v11) || isnan(v10));
  q.n = static_cast<int>(crossing(v00, v01)) + crossing(v01, v11) +
        crossing(v10, v11) + crossing(v00, v10);
  return q;
}

// "clean" quad: finite corners and 2 or 4 crossed edges (layer 0's mask,
// the suppression test of the virtual layers); false outside the quads
__device__ __forceinline__ bool clean(const float* __restrict__ tsd, int H,
                                      int W, int y, int x) {
  if (y < 0 || y >= H - 1 || x < 0 || x >= W - 1) return false;
  const Quad q = quad(tsd, W, y, x);
  return q.ok && (q.n == 2 || q.n == 4);
}

__global__ void segment_layers_kernel(const float* __restrict__ tsd,
                                      float* __restrict__ mask,
                                      int* __restrict__ row_cnt, int H,
                                      int W) {
  const int x = blockIdx.x * kRow + threadIdx.x;
  const int y = blockIdx.y;
  const long cell = static_cast<long>(y) * W + x;

  bool l0 = false, l1 = false;
  if (y < H - 1 && x < W - 1) {
    const Quad q = quad(tsd, W, y, x);
    l0 = q.ok && (q.n == 2 || q.n == 4);
    l1 = q.ok && q.n == 4;
  }
  const float v = tsd[cell];
  // h-edge (y, x): suppressed when quad (y, x) or (y-1, x) is clean
  const bool l2 = x < W - 1 && crossing(v, tsd[cell + 1]) &&
                  !(l0 || clean(tsd, H, W, y - 1, x));
  // v-edge (y, x): suppressed when quad (y, x) or (y, x-1) is clean
  const bool l3 = y < H - 1 && crossing(v, tsd[cell + W]) &&
                  !(l0 || clean(tsd, H, W, y, x - 1));

  const long plane = static_cast<long>(H) * W;
  mask[cell] = l0 ? 1.0f : 0.0f;
  mask[plane + cell] = l1 ? 1.0f : 0.0f;
  mask[2 * plane + cell] = l2 ? 1.0f : 0.0f;
  mask[3 * plane + cell] = l3 ? 1.0f : 0.0f;

  const int c0 = __syncthreads_count(l0);
  const int c1 = __syncthreads_count(l1);
  const int c2 = __syncthreads_count(l2);
  const int c3 = __syncthreads_count(l3);
  if (threadIdx.x == 0) {
    const long row = cell / kRow;
    const long rows = plane / kRow;
    row_cnt[row] = c0;
    row_cnt[rows + row] = c1;
    row_cnt[2 * rows + row] = c2;
    row_cnt[3 * rows + row] = c3;
  }
}

}  // namespace

// tsd: [H, W] float32, row-major, W % 128 == 0.  Writes mask [4, H, W]
// float32 and row_cnt [4 * H * W / 128] int32 on `stream`.  Returns the
// cudaError_t of the launch.
extern "C" int segment_layers_f32(const float* tsd, float* mask,
                                  int* row_cnt, int H, int W, void* stream) {
  const dim3 grid(W / kRow, H);
  segment_layers_kernel<<<grid, kRow, 0, static_cast<cudaStream_t>(stream)>>>(
      tsd, mask, row_cnt, H, W);
  return static_cast<int>(cudaGetLastError());
}
