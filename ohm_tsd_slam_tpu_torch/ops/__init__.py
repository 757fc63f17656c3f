"""Hand-written CUDA kernels for the port's hot ops, one wrapper module
each: push_cuda wraps csrc/push.cu; segment_layers_cuda, pack_rows_cuda,
segment_min_cuda, window_replay_cuda (two entry points: window_replay and
window_rounds) and compact_channels_cuda wrap the fast caster's kernels
(csrc/<name>.cu; csrc/scan_rows.cuh is the prefix and row walk that the
row pack and the channel compaction share).  kernel_check holds each
against its plain twin, the push kernel's per-tile cull included.
graph_cond_cuda wraps csrc/graph_cond.cu, no kernel of the JAX package:
the conditional (IF) nodes that utils/compiled.py::when puts in a
captured graph.  assign_pairs_cuda wraps csrc/assign_pairs.cu, no kernel
of the JAX package either: ICP's pair assignment, whose twin is
registration/nn.py::assign_pairs_plain; nearest_model_cuda wraps
csrc/nearest_model.cu, nor one: the nearest-model-point search of RANSAC
mode EXP, whose twin is registration/ransac.py::nearest_model_plain.

The plain torch functions in grid/ (and registration/) are each
kernel's reference and its CPU path.  No module here imports a compiler
or builds a kernel at import time: ops/_build.py compiles csrc/*.cu at a
kernel's first launch.
"""
