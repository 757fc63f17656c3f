"""Hand-written CUDA kernels for the port's hot ops (one module each:
push_cuda wraps csrc/push.cu).

The plain torch functions in grid/ are each kernel's reference and its
CPU path.  No module here imports a compiler or builds a kernel at import
time: ops/_build.py compiles csrc/*.cu at a kernel's first launch.
"""
