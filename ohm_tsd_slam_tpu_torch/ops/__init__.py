"""Hand-written CUDA kernels for the port's hot ops, one wrapper module
each: push_cuda wraps csrc/push.cu; segment_layers_cuda, pack_rows_cuda,
segment_min_cuda, window_replay_cuda (two entry points: window_replay and
window_rounds) and compact_channels_cuda wrap the fast caster's kernels
(csrc/<name>.cu).  kernel_check holds each against its plain twin, the
push kernel's per-tile cull included.

The plain torch functions in grid/ are each kernel's reference and its
CPU path.  No module here imports a compiler or builds a kernel at import
time: ops/_build.py compiles csrc/*.cu at a kernel's first launch.
"""
