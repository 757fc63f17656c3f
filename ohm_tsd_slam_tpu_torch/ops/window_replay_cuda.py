"""Exact-march window replay with crossing normals on the card: the
wrapper of csrc/window_replay.cu (kernel D of the fast caster).

Replaces the TPU kernels ohm_tsd_slam_tpu/ops/window_block_pallas.py::
window_block_pallas and window_single_pallas: one kernel serves round 1 and
the compacted later rounds.  The plain version is
grid/raycast_fast.py::window_replay_plain; the wrapper runs it for a grid on
the CPU.  For a grid on CUDA it launches the kernel or raises;
`window_replay.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ohm_tsd_slam_tpu_torch.grid.raycast_fast import window_replay_plain
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("window_replay")
    fn = lib.window_replay_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _F, _P, _P, _P, _P, _P, _P, _I, _P]
        fn.restype = _I
    return lib


def window_replay(grid: TsdGrid, tw0: torch.Tensor, ray: torch.Tensor,
                  idx_max: torch.Tensor, active: torch.Tensor,
                  tr: torch.Tensor) -> torch.Tensor:
    """[N, 8] per beam: hit, any_ev, pos_x, pos_y, interp, nx, ny, n_ok
    (see window_replay_plain); zeros for an inactive beam."""
    tsd = grid.tsd
    if not tsd.is_cuda:
        return window_replay_plain(grid, tw0, ray, idx_max, active, tr)
    dev = tsd.device
    H, W = tsd.shape
    N = tw0.shape[0]
    if tsd.dtype != torch.float32 or not tsd.is_contiguous():
        raise TypeError("window_replay: the kernel takes a contiguous "
                        f"float32 field, got {tsd.dtype}")
    flat = {}
    for name, t, numel in (("tw0", tw0, N), ("ray", ray, 2 * N),
                           ("idx_max", idx_max, N), ("tr", tr, 2)):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != numel:
            raise TypeError(f"window_replay: {name} must be float32 with "
                            f"{numel} elements on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
        flat[name] = t.contiguous()
    if (active.device != dev or active.dtype != torch.bool
            or active.numel() != N):
        raise TypeError(f"window_replay: active must be bool [{N}] on {dev}")
    active = active.contiguous()
    out = torch.empty((N, 8), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.window_replay_f32(
            tsd.data_ptr(), H, W, grid.cell_size, flat["tw0"].data_ptr(),
            flat["ray"].data_ptr(), flat["idx_max"].data_ptr(),
            active.data_ptr(), flat["tr"].data_ptr(), out.data_ptr(), N,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"window_replay_f32 launch failed: cudaError {err}")
    window_replay.launches += 1
    return out


window_replay.launches = 0
