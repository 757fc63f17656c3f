"""EXP's nearest-model-point search on the card: the wrapper of
csrc/nearest_model.cu.

Replaces no TPU kernel (the JAX package leaves match_normal to XLA): the
port's own kernel for registration/ransac.py::match_normal's 1-NN of every
transformed control point into the valid model, with the nearest point's
normal as payload.  The plain version is
registration/ransac.py::nearest_model_plain; the wrapper runs it for
tensors on the CPU.  For tensors on CUDA it launches the kernel or raises,
and returns what the plain version returns on the card, in every bit, on
the queries of the candidates with `valid` set (elsewhere d2min +inf, idx
-1 and a zero payload: see the kernel's header).  `nearest_model.launches`
counts the calls that launch: one kernel a call.
"""

from __future__ import annotations

import ctypes

import torch

from ohm_tsd_slam_tpu_torch.ops import _build
from ohm_tsd_slam_tpu_torch.registration.ransac import nearest_model_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "nearest_model_f32",
          torch.float64: "nearest_model_f64"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("nearest_model"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                       _P, _P]
        fn.restype = _I
    return fn


def check_inputs(st: torch.Tensor, q2: torch.Tensor, model: torch.Tensor,
                 model_masked_sq: torch.Tensor, cosm: torch.Tensor,
                 sinm: torch.Tensor, valid: torch.Tensor):
    """The inputs as the kernel takes them: st [K, C, 2], q2 [K, C],
    model [M, 2], model_masked_sq, cosm and sinm [M] of one float type
    (float32 or float64), the bool mask valid [K], all on
    one device and contiguous (copied where they are not), K, C and M at
    least 1.  Raises TypeError or ValueError on anything else."""
    dev, dtype = st.device, st.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"nearest_model: the points must be float32 or "
                        f"float64, got {dtype}")
    if st.dim() != 3:
        raise TypeError(f"nearest_model: st must be [K, C, 2], got "
                        f"{tuple(st.shape)}")
    K, C, M = st.shape[0], st.shape[1], model.shape[0]
    if K < 1 or C < 1 or M < 1:
        raise ValueError(f"nearest_model: needs a candidate, a control "
                         f"point and a model point, got K={K}, C={C}, M={M}")
    want = {"st": (st, dtype, (K, C, 2)), "q2": (q2, dtype, (K, C)),
            "model": (model, dtype, (M, 2)),
            "model_masked_sq": (model_masked_sq, dtype, (M,)),
            "cosm": (cosm, dtype, (M,)), "sinm": (sinm, dtype, (M,)),
            "valid": (valid, torch.bool, (K,))}
    out = []
    for name, (t, t_dtype, shape) in want.items():
        if t.device != dev or t.dtype != t_dtype or tuple(t.shape) != shape:
            raise TypeError(f"nearest_model: {name} must be {t_dtype} of "
                            f"shape {shape} on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
        out.append(t.contiguous())
    return out


def nearest_model(st: torch.Tensor, q2: torch.Tensor, model: torch.Tensor,
                  model_masked_sq: torch.Tensor, cosm: torch.Tensor,
                  sinm: torch.Tensor, valid: torch.Tensor, chunk: int):
    """EXP's nearest model point (registration/ransac.py::
    nearest_model_plain, which takes `chunk` on the CPU): d2min [K, C],
    idx [K, C] int32, cos_nn [K, C], sin_nn [K, C]."""
    if not st.is_cuda:
        return nearest_model_plain(st, q2, model, model_masked_sq, cosm,
                                   sinm, chunk)
    st, q2, model, model_masked_sq, cosm, sinm, valid = check_inputs(
        st, q2, model, model_masked_sq, cosm, sinm, valid)
    dev, dtype = st.device, st.dtype
    K, C, M = st.shape[0], st.shape[1], model.shape[0]
    d2min = torch.empty((K, C), dtype=dtype, device=dev)
    idx = torch.empty((K, C), dtype=torch.int32, device=dev)
    cos_nn = torch.empty((K, C), dtype=dtype, device=dev)
    sin_nn = torch.empty((K, C), dtype=dtype, device=dev)
    fn = _entry(dtype)
    with torch.cuda.device(dev):
        err = fn(st.data_ptr(), q2.data_ptr(), valid.data_ptr(), K, C,
                 model.data_ptr(), model_masked_sq.data_ptr(), M,
                 cosm.data_ptr(), sinm.data_ptr(),
                 d2min.data_ptr(), idx.data_ptr(), cos_nn.data_ptr(),
                 sin_nn.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[dtype]} launch failed: cudaError {err}")
    nearest_model.launches += 1
    return d2min, idx, cos_nn, sin_nn


nearest_model.launches = 0
