// Conditional (IF) nodes of a CUDA graph under stream capture, for
// utils/compiled.py::when: the port's lax.cond inside a captured graph.
//
// graph_if_begin adds to the graph that `stream` is capturing a kernel
// that sets a conditional handle from the device bool *pred at each
// launch, then an IF node on that handle that depends on it, makes the
// node the stream's only capture dependency (what the stream captures
// next runs after the node) and returns the node's body graph.  The
// caller captures the body on another stream with graph_body_begin /
// graph_body_end.  The handle is reset to 0 at every launch of the graph
// (cudaGraphCondAssignDefault), so the body runs exactly on the launches
// where *pred is true.  Needs CUDA 12.4 (conditional nodes with a body
// graph created by cudaGraphAddNode).
//
// Plain C interface: each entry point returns a cudaError_t (0 on
// success), or -1 when `stream` is not capturing.

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

namespace {

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  nullptr, n);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, n);
#endif
}

}  // namespace

extern "C" int graph_cond_ready(void) {
  // the runtime's context and the setter's module, before any capture
  cudaFuncAttributes attr;
  cudaError_t err = cudaFree(nullptr);
  if (err != cudaSuccess) return err;
  return cudaFuncGetAttributes(&attr, set_if_kernel);
}

extern "C" int graph_if_begin(cudaStream_t stream, const bool* pred,
                              cudaGraph_t* body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = capture_info(stream, &status, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the setter is the stream's dependency now
  err = capture_info(stream, &status, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *body = params.conditional.phGraph_out[0];
  return cudaSuccess;
}

extern "C" int graph_body_begin(cudaStream_t stream, cudaGraph_t body) {
  return cudaStreamBeginCaptureToGraph(stream, body, nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_body_end(cudaStream_t stream) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(stream, &graph);
}
