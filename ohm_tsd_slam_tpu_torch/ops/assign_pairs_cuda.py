"""ICP's pair assignment on the card: the wrapper of csrc/assign_pairs.cu.

Replaces no TPU kernel (the JAX package leaves its assign_pairs_fused to
XLA): the port's own kernel for the [S, M] nearest-neighbour search, the
distance gate, the reciprocal rule and the payload gather of one ICP
iteration.  The plain version is registration/nn.py::assign_pairs_plain;
the wrapper runs it for tensors on the CPU.  For tensors on CUDA it
launches the kernel or raises, and returns what the plain version returns
on the card, in every bit.  `assign_pairs.launches` counts the calls that
launch: one a call (a memset and two kernels with the reciprocal rule,
three kernels in float64; one kernel without it).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from ohm_tsd_slam_tpu_torch.ops import _build
from ohm_tsd_slam_tpu_torch.registration.nn import assign_pairs_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "assign_pairs_f32", torch.float64: "assign_pairs_f64"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("assign_pairs"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P]
        fn.restype = _I
    return fn


def check_inputs(model: torch.Tensor, model_mask: torch.Tensor,
                 scene: torch.Tensor, scene_mask: torch.Tensor,
                 payload: torch.Tensor, thresh2=None):
    """The inputs as the kernel takes them: model [M, 2], scene [S, 2] and
    payload [M, K] of one float type (float32 or float64), bool masks
    [M] and [S], all on one device and contiguous (copied where they are
    not), S and M at least 1; the gate None, a number or a one-element
    tensor on that device, returned as a 0-dim tensor of the clouds' type
    (a number rounded to it, as the plain version's compare rounds it).
    Raises TypeError or ValueError on anything else."""
    dev, dtype = scene.device, scene.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"assign_pairs: the clouds must be float32 or "
                        f"float64, got {dtype}")
    S, M = scene.shape[0], model.shape[0]
    if S < 1 or M < 1:
        raise ValueError(f"assign_pairs: needs a scene and a model point, "
                         f"got S={S}, M={M}")
    want = {"model": (model, dtype, (M, 2)),
            "model_mask": (model_mask, torch.bool, (M,)),
            "scene": (scene, dtype, (S, 2)),
            "scene_mask": (scene_mask, torch.bool, (S,)),
            "payload": (payload, dtype,
                        (M, payload.shape[1] if payload.dim() == 2 else -1))}
    out = []
    for name, (t, t_dtype, shape) in want.items():
        if t.device != dev or t.dtype != t_dtype or tuple(t.shape) != shape:
            raise TypeError(f"assign_pairs: {name} must be {t_dtype} of "
                            f"shape {shape} on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    if thresh2 is None:
        gate = None
    elif isinstance(thresh2, torch.Tensor):
        if thresh2.device != dev or thresh2.numel() != 1:
            raise TypeError(f"assign_pairs: a gate tensor must hold one "
                            f"value on {dev}, got {tuple(thresh2.shape)} on "
                            f"{thresh2.device}")
        gate = thresh2.reshape(()).to(dtype)
    elif isinstance(thresh2, numbers.Real):
        gate = torch.full((), float(thresh2), dtype=dtype, device=dev)
    else:
        raise TypeError(f"assign_pairs: the gate must be None, a number or "
                        f"a tensor, got {type(thresh2).__name__}")
    return (*out, gate)


def assign_pairs(model: torch.Tensor, model_mask: torch.Tensor,
                 scene: torch.Tensor, scene_mask: torch.Tensor,
                 payload: torch.Tensor, thresh2=None,
                 use_reciprocal: bool = True):
    """One ICP pair assignment (registration/nn.py::assign_pairs_fused):
    idx (S,) int32, dist2 (S,), pair_mask (S,), paired (S, K)."""
    if not scene.is_cuda:
        return assign_pairs_plain(model, model_mask, scene, scene_mask,
                                  payload, thresh2, use_reciprocal)
    model, model_mask, scene, scene_mask, payload, gate = check_inputs(
        model, model_mask, scene, scene_mask, payload, thresh2)
    dev, dtype = scene.device, scene.dtype
    S, M, K = scene.shape[0], model.shape[0], payload.shape[1]
    idx = torch.empty(S, dtype=torch.int32, device=dev)
    dist2 = torch.empty(S, dtype=dtype, device=dev)
    pair_mask = torch.empty(S, dtype=torch.bool, device=dev)
    paired = torch.empty((S, K), dtype=dtype, device=dev)
    # the columns' keys (8 bytes a model point; float64 4 more for the
    # ties' least scene index), set by the launch itself
    work = (torch.empty(M * (3 if dtype == torch.float64 else 2),
                        dtype=torch.int32, device=dev)
            if use_reciprocal else None)
    fn = _entry(dtype)
    with torch.cuda.device(dev):
        err = fn(model.data_ptr(), model_mask.data_ptr(), scene.data_ptr(),
                 scene_mask.data_ptr(), payload.data_ptr(), K, S, M,
                 None if gate is None else gate.data_ptr(),
                 None if work is None else work.data_ptr(), idx.data_ptr(),
                 dist2.data_ptr(), pair_mask.data_ptr(), paired.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[dtype]} launch failed: cudaError {err}")
    assign_pairs.launches += 1
    return idx, dist2, pair_mask, paired


assign_pairs.launches = 0
