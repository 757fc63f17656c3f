"""Hand-written CUDA kernels for the port's hot ops, one wrapper module
each: push_cuda wraps csrc/push.cu; segment_layers_cuda, pack_rows_cuda,
segment_min_cuda, window_replay_cuda and compact_channels_cuda wrap the
fast caster's kernels (csrc/<name>.cu), which kernel_check holds against
their plain twins.

The plain torch functions in grid/ are each kernel's reference and its
CPU path.  No module here imports a compiler or builds a kernel at import
time: ops/_build.py compiles csrc/*.cu at a kernel's first launch.
"""
