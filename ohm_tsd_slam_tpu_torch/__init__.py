"""ohm_tsd_slam_tpu_torch — the PyTorch/CUDA port of ohm_tsd_slam_tpu.

A second package beside the JAX one (which stays the reference), with the
same subpackage layout and file names so each module's counterpart is
easy to find.  It imports torch and never jax.  Functions take tensors on
an explicit device and keep the dtype of their inputs: float64 for the CPU
parity tests, float32 on the card.  There is no jit; `lax.scan` loops are
Python loops.  The TSD fusion push runs as a hand-written CUDA kernel
(csrc/push.cu, bound in ops/push_cuda.py) for float32 grids on CUDA.
"""

import torch as _torch

# Counterpart of the JAX package's "highest" matmul-precision pin
# (ohm_tsd_slam_tpu/__init__.py): reduced-precision passes shift
# back-projected beam bins, so TF32 stays off for matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ohm_tsd_slam_tpu_torch.version import __version__  # noqa: E402

__all__ = ["__version__"]
