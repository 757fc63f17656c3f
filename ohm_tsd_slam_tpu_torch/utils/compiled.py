"""Compiled entry points: the port's counterpart of `jax.jit`.

`compiled(fn, static_argnames=...)` returns a callable with fn's
signature.  For tensors on the CPU it calls fn eagerly and builds nothing.
For tensors on a CUDA device it keeps one `torch.cuda.CUDAGraph` of fn per
key and replays it: the same kernels as the eager call, captured once and
launched with one call, so the host no longer pays for each of the step's
thousands of small launches.

The key holds what fn's Python sees at capture and a replay cannot see:
  * the static arguments (`static_argnames`: hashable values such as
    LocalizeParams or SensorPolar2D), and every argument that is not a
    tensor, a generator or a container of them (None, numbers, strings),
    by value, so the `None`-ness of an optional tensor is part of it;
  * each tensor's shape, dtype and device;
  * the structure of the containers (tuples, NamedTuples, lists, dicts,
    dataclasses such as TsdGrid).
A host-side branch of fn that depends on anything else (a segment cache's
staleness) must be decided by the caller and passed in as such a value:
see grid/raycast_fast.py::raycast_fast_jit.

On a key it has not seen, the wrapper copies the arguments into static
buffers, runs fn once on a side stream (the warm-up: the first call builds
the CUDA sources, ops/_build.py, and fills the caches of the kernels'
launch configuration), then captures fn into a graph over those buffers.
A capture that fails raises; the eager function never runs on the card in
its place.  On every call it copies each tensor into its buffer unless the
buffer already holds that very tensor at the same `_version` (a grid of
4 x 1024^2 cells is copied once per map update, not once per scan), replays
the graph and returns clones of the outputs (a replay overwrites the
graph's own outputs, and the caller keeps them: the node keeps `res.pose`
as the robot's pose).

A `torch.Generator` argument is replaced at capture by a generator of the
graph's own (`CUDAGraph.register_generator_state`); each call hands it the
caller's state before the replay and gives the caller the state the
replay left, so the draws and the caller's stream equal the eager call's
in every bit.

One graph is replayed by one thread at a time: a lock of its own covers
the copy into its buffers, the replay and the clones, and an event makes
a call on another stream wait for the clones of the last one.  Captures
are serialised by one lock and use the `thread_local` capture mode, so a
thread that replays or runs eagerly meanwhile does not break a capture.

A branch on a device value inside fn goes through `when(pred, fn, out)`:
eagerly it reads `pred` once and branches on the host; under a capture
it puts fn's kernels in a conditional (IF) node of the graph, so one
graph serves both branches and a replay reads nothing back.  The warm-up
runs both branches, so that the ops of the branch the warm-up's inputs do
not take have run once before the capture too.

The kernel wrappers count their launches in Python (`fn.launches`, see
ops/*_cuda.py): the warm-up and the capture call them, a replay does not.
What the device ran on a compiled path is read from a trace of it
(tests/test_torch_paths_cuda.py::
test_compiled_path_launches_from_a_trace).  Each graph keeps its static
buffers and its memory pool until `clear_cache()` drops it, as a jitted
function keeps its executables.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ohm_tsd_slam_tpu_torch.utils import spans

_capture_lock = threading.Lock()
# `.warming`: this thread runs the warm-up call of a capture; `.capture`:
# the _Graph this thread is capturing (see `when`)
_local = threading.local()


# --------------------------------------------------------------------------
# flattening: arguments and results as a hashable spec and a list of leaves
# --------------------------------------------------------------------------

def flatten(x: Any, leaves: list):
    """The hashable spec of `x`; its tensors and generators are appended
    to `leaves` in order.  Anything else must be hashable and goes into
    the spec by type and value."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, torch.Generator):
        leaves.append(x)
        return ("generator", x.device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("namedtuple", type(x),
                tuple(flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, flatten(v, leaves)) for k, v in x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dataclass", type(x),
                tuple((f.name, flatten(getattr(x, f.name), leaves))
                      for f in dataclasses.fields(x)))
    hash(x)      # a static value: raises for an unhashable argument
    return ("static", type(x), x)


def unflatten(spec, leaves: Iterable):
    """The value of `spec` with its leaves taken in order from `leaves`."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind in ("tensor", "generator"):
            return next(it)
        if kind == "namedtuple":
            return s[1](*(build(v) for v in s[2]))
        if kind in ("tuple", "list"):
            return (tuple if kind == "tuple" else list)(build(v)
                                                        for v in s[1])
        if kind == "dict":
            return {k: build(v) for k, v in s[1]}
        if kind == "dataclass":
            return s[1](**{k: build(v) for k, v in s[2]})
        return s[2]

    return build(spec)


def cuda_device(leaves: list) -> Optional[torch.device]:
    """The CUDA device of the leaves, or None when none is on CUDA (the
    eager CPU path).  Leaves on two devices raise."""
    devs = {leaf.device for leaf in leaves}
    if not any(d.type == "cuda" for d in devs):
        return None
    # a generator made with device="cuda" names no index: the current one
    devs = {torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs}
    if len(devs) > 1:
        raise ValueError(f"compiled: arguments on several devices {devs}")
    return devs.pop()


# --------------------------------------------------------------------------
# a branch on a device value
# --------------------------------------------------------------------------

def when(pred: torch.Tensor, fn: Callable[[], Any], out):
    """`fn()` where the 0-dim tensor `pred` is true, else `out`: the
    port's `lax.cond(pred, fn, lambda: out)`.  fn's result must have
    out's structure, shapes and dtypes.

    On the CPU, and on the card outside a capture, it reads `pred` once
    and branches on the host; the warm-up of a capture (`compiled`) runs
    fn whichever way `pred` goes, so that both branches' ops have run
    once before the capture.  Under a capture by `compiled` it records fn
    into a conditional (IF) node of the graph on `pred`
    (ops/graph_cond_cuda.py) and copies fn's result into out's tensors
    inside the node, so that what follows reads one set of buffers
    whichever branch a replay takes (a leaf that fn returns unchanged is
    not copied); it returns `out` then.  Under any other capture, or where
    the node cannot be added, it raises: the eager branch never stands in
    for the graph's."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        from ohm_tsd_slam_tpu_torch.ops import graph_cond_cuda

        graph = getattr(_local, "capture", None)
        if graph is None:
            raise RuntimeError("when: a capture not made by compiled() "
                               "cannot hold a conditional node")
        with graph_cond_cuda.if_body(pred.to(torch.bool),
                                     graph.body_pool()):
            graph.body_uses += 1        # if_body took a reference
            taken = fn()
            leaves_out, leaves_taken = [], []
            if flatten(out, leaves_out) != flatten(taken, leaves_taken):
                raise ValueError("when: fn's result differs from out in "
                                 "structure, shape or dtype")
            for o, t in zip(leaves_out, leaves_taken):
                if t is not o:
                    o.copy_(t)
        return out
    if getattr(_local, "warming", False):
        if pred.is_cuda:
            from ohm_tsd_slam_tpu_torch.ops import graph_cond_cuda

            graph_cond_cuda.ready()
        taken = fn()
        return taken if bool(pred) else out
    return fn() if bool(pred) else out


# --------------------------------------------------------------------------
# one captured graph
# --------------------------------------------------------------------------

class _Graph:
    """A graph of fn over static buffers, its outputs and what it needs
    to be replayed: see the module docstring."""

    def __init__(self, fn: Callable, spec, leaves: list,
                 device: torch.device):
        self.lock = threading.Lock()
        self.done = None        # event after the last call's clones
        self.static = []        # a buffer a tensor, a generator a generator
        self.gens = []          # (leaf index, the graph's generator)
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Generator):
                g = torch.Generator(device=device)
                g.set_state(leaf.get_state())
                self.gens.append((i, g))
                self.static.append(g)
            else:
                self.static.append(leaf.detach().clone())
        self.tensors = [i for i, b in enumerate(self.static)
                        if isinstance(b, torch.Tensor)]
        # (the caller's tensor, its version) that each buffer holds
        self.source: Dict[int, Tuple[weakref.ref, int]] = {}
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        _local.warming = True
        try:
            with torch.cuda.stream(side):
                fn(unflatten(spec, self.static))     # the warm-up
        finally:
            _local.warming = False
        stream.wait_stream(side)
        versions = [self.static[i]._version for i in self.tensors]
        self.graph = torch.cuda.CUDAGraph()
        self.device = device
        self._body_pool, self.body_uses = None, 0
        for _, g in self.gens:
            self.graph.register_generator_state(g)
        _local.capture = self
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                out = fn(unflatten(spec, self.static))
        finally:
            _local.capture = None
        # a buffer that fn writes is copied on every call
        self.written = {i for i, v in zip(self.tensors, versions)
                        if self.static[i]._version != v}
        self.out_leaves: list = []
        self.out_spec = flatten(out, self.out_leaves)
        self.capture_s = time.perf_counter() - t0

    def body_pool(self):
        """The private memory pool of this graph's conditional nodes'
        bodies (`when`); `body_uses` counts the references they took,
        given back when the graph is dropped."""
        if self._body_pool is None:
            from ohm_tsd_slam_tpu_torch.ops import graph_cond_cuda

            self._body_pool = torch.cuda.graph_pool_handle()
            self._release = graph_cond_cuda.release
        return self._body_pool

    def __del__(self):
        # at interpreter exit the allocator goes with the process
        if getattr(self, "body_uses", 0) and not sys.is_finalizing():
            self._release(self.device, self._body_pool, self.body_uses)

    def __call__(self, leaves: list, device: torch.device):
        with self.lock:
            stream = torch.cuda.current_stream(device)
            if self.done is not None:
                stream.wait_event(self.done)
            with spans.span("copy_in") as s:
                copied = nbytes = 0
                for i in self.tensors:
                    leaf, src = leaves[i], self.source.get(i)
                    if (i in self.written or src is None
                            or src[0]() is not leaf
                            or src[1] != leaf._version):
                        self.static[i].copy_(leaf.detach())
                        self.source[i] = (weakref.ref(leaf), leaf._version)
                        copied += 1
                        nbytes += leaf.nbytes
                for i, g in self.gens:
                    g.set_state(leaves[i].get_state())
                if s is not None:
                    s.attrs.update(buffers=copied, bytes=nbytes)
            with spans.span("replay"), spans.device_interval("replay",
                                                             device):
                self.graph.replay()
            with spans.span("clone_out"):
                for i, g in self.gens:
                    leaves[i].set_state(g.get_state())
                outs = [o.clone() if isinstance(o, torch.Tensor) else o
                        for o in self.out_leaves]
                if self.done is None:
                    self.done = torch.cuda.Event()
                self.done.record(stream)
        return unflatten(self.out_spec, outs)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

class Compiled:
    """fn, captured per key into a CUDA graph on the card and run eagerly
    on the CPU (see the module docstring).  `captures` counts the graphs
    built, `replays` the calls served by one, `capture_s` lists each
    capture's seconds (warm-up included).  With the span recorder on
    (utils/spans.py) each call records a span named `name`, and each
    capture counts into its counter `captures`."""

    def __init__(self, fn: Callable, static_argnames: Iterable[str] = (),
                 name: Optional[str] = None):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.name = name or fn.__name__
        self.signature = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        for name in self.static_argnames:
            if name not in self.signature.parameters:
                raise ValueError(f"{fn.__name__} has no argument {name!r}")
        if any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD, p.POSITIONAL_ONLY)
               for p in self.signature.parameters.values()):
            raise ValueError(f"{fn.__name__}: compiled takes named "
                             "arguments only")
        self._graphs: Dict[Any, _Graph] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s: List[float] = []

    def key(self, *args, **kwargs) -> Tuple[Any, list]:
        """The cache key of a call and its leaves (tensors, generators)."""
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        static = tuple((n, bound.arguments[n]) for n in self.static_argnames)
        for name, value in static:
            try:
                hash(value)
            except TypeError:
                raise TypeError(f"{self.fn.__name__}: static argument "
                                f"{name!r} must be hashable") from None
        dynamic = {n: v for n, v in bound.arguments.items()
                   if n not in self.static_argnames}
        leaves: list = []
        spec = flatten(dynamic, leaves)
        return (static, spec), leaves

    def __call__(self, *args, **kwargs):
        if spans.enabled():
            return self._traced(args, kwargs)
        key, leaves = self.key(*args, **kwargs)
        device = cuda_device(leaves)
        if device is None:
            return self.fn(*args, **kwargs)
        graph = self._graph(key, leaves, device)
        self.replays += 1
        return graph(leaves, device)

    def _traced(self, args: tuple, kwargs: dict):
        """A call with the span recorder on (utils/spans.py): a span named
        `self.name`; on the card with the children `key`, `capture` (on
        a new key), `copy_in`, `replay` (and its device interval) and
        `clone_out`; on the CPU with the attr `eager` and no children."""
        with spans.span(self.name) as top:
            t0 = time.time_ns()
            key, leaves = self.key(*args, **kwargs)
            device = cuda_device(leaves)
            if device is None:
                if top is not None:
                    top.attrs["eager"] = True
                return self.fn(*args, **kwargs)
            spans.add("key", t0)
            graph = self._graph(key, leaves, device)
            self.replays += 1
            return graph(leaves, device)

    def _graph(self, key, leaves: list, device: torch.device) -> _Graph:
        """The graph of `key`, captured now where there is none."""
        graph = self._graphs.get(key)
        if graph is None:
            with _capture_lock:
                graph = self._graphs.get(key)
                if graph is None:
                    with spans.span("capture") as s:
                        graph = _Graph(functools.partial(self._call, key[0]),
                                       key[1], leaves, device)
                        if s is not None:
                            s.attrs["capture_s"] = graph.capture_s
                    spans.count("captures")
                    self._graphs[key] = graph
                    self.captures += 1
                    self.capture_s.append(graph.capture_s)
        return graph

    def _call(self, static, dynamic: dict):
        return self.fn(**dynamic, **dict(static))

    def graphs(self) -> List[_Graph]:
        """The graphs captured so far, in order."""
        return list(self._graphs.values())

    def clear_cache(self) -> None:
        """Drop every graph (`jax.jit(fn).clear_cache()`): its buffers and
        its pool go back to the caching allocator; the next call of a key
        captures it again."""
        with _capture_lock:
            self._graphs.clear()


def compiled(fn: Callable, static_argnames: Iterable[str] = (),
             name: Optional[str] = None) -> Compiled:
    """`jax.jit(fn, static_argnames=...)` for the port: see the module
    docstring.  `name` (fn's by default) names the calls' spans: the
    public entry point that calls it."""
    return Compiled(fn, static_argnames, name)
