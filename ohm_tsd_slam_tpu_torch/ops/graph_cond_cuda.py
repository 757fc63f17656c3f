"""Conditional (IF) nodes of a captured CUDA graph: the wrapper of
csrc/graph_cond.cu, for utils/compiled.py::when.

Not a port of a TPU kernel: the JAX package branches inside a compiled
function with `lax.cond`, which XLA lowers to a conditional; a CUDA graph
captured by torch has none unless it adds one, and the torch build this
port runs on does not offer one (`CUDAGraph.begin_capture_to_if_node`
came later).  `if_body(pred, pool)` adds, to the graph the current
stream is capturing, a one-thread kernel that sets a conditional handle
from the device bool `pred` and an IF node on it, and captures what runs
inside the `with` block into the node's body graph, on a stream of its
own whose allocations come from the private memory pool `pool` (a
`torch.cuda.graph_pool_handle()`): the body runs on a replay exactly when
`pred` is true, and what the stream captures after the block runs after
the node.  Each `if_body` takes a reference to the pool, as a capture
takes one to its graph's; the graph that holds the node gives it back
(`release`) when it is dropped, and the caching allocator frees the pool's
memory once no reference is left.  Every failure raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("graph_cond")
    if lib.graph_if_begin.argtypes is None:
        lib.graph_cond_ready.argtypes = []
        lib.graph_if_begin.argtypes = [_P, _P, ctypes.POINTER(_P)]
        lib.graph_body_begin.argtypes = [_P, _P]
        lib.graph_body_end.argtypes = [_P]
        for fn in (lib.graph_cond_ready, lib.graph_if_begin,
                   lib.graph_body_begin, lib.graph_body_end):
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: the current stream is not capturing")
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def ready() -> None:
    """Load the library and its setter kernel outside any capture (a
    capture's warm-up calls it)."""
    _check(_lib().graph_cond_ready(), "graph_cond_ready")


def release(device: torch.device, pool, uses: int) -> None:
    """Give back the references `uses` calls of if_body took to `pool`."""
    for _ in range(uses):
        torch._C._cuda_releasePool(device.index, pool)


def _idle_stream(dev: torch.device) -> torch.cuda.Stream:
    """A stream of torch's pool that is not capturing.  The pool hands out
    its 32 streams in turn, and torch.cuda.graph captures on one of them,
    so a stream taken at random can be the capture's own (beginning a
    body's capture on it fails with cudaErrorIllegalState)."""
    for _ in range(64):
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            if not torch.cuda.is_current_stream_capturing():
                return side
    raise RuntimeError("if_body: every stream of the pool is capturing")


@contextlib.contextmanager
def if_body(pred: torch.Tensor, pool):
    """The work captured inside runs on a replay only where `pred`, a
    0-dim bool tensor on the card, is true (see the module docstring).
    Inside, the current stream is the body's; its allocations go to the
    private pool `pool`, of which it keeps a reference (`release`)."""
    if pred.dtype != torch.bool or pred.dim() != 0 or not pred.is_cuda:
        raise ValueError("if_body: pred must be a 0-dim bool CUDA tensor")
    lib = _lib()
    dev = pred.device
    body = _P()
    _check(lib.graph_if_begin(torch.cuda.current_stream(dev).cuda_stream,
                              pred.data_ptr(), ctypes.byref(body)),
           "graph_if_begin")
    side = _idle_stream(dev)
    with torch.cuda.stream(side):
        torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
        try:
            _check(lib.graph_body_begin(side.cuda_stream, body),
                   "graph_body_begin")
            try:
                yield
            finally:
                err = lib.graph_body_end(side.cuda_stream)
            _check(err, "graph_body_end")
        finally:
            torch._C._cuda_endAllocateToPool(dev.index, pool)
