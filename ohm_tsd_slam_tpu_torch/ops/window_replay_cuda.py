"""Exact-march window replay with crossing normals on the card: the
wrappers of csrc/window_replay.cu (kernel D of the fast caster).

Replaces the TPU kernels ohm_tsd_slam_tpu/ops/window_block_pallas.py::
window_block_pallas and window_single_pallas.  The source has two entry
points: `window_replay` replays every beam's first candidate window (round
1, eight lanes a beam), `window_rounds` runs rounds 2..ROUNDS on the
per-beam state in one launch (one block; selection, replay and update in
place).  Their plain versions are grid/raycast_fast.py::window_replay_plain
and window_rounds_plain; a wrapper runs its plain version for a grid on the
CPU.  For a grid on CUDA it launches the kernel or raises;
`window_replay.launches` and `window_rounds.launches` count the launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    window_replay_plain,
    window_rounds_plain,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# the rounds kernel lists a round's beams in static-limit shared memory
MAX_CAP = 48 * 1024 // 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("window_replay")
    if lib.window_replay_f32.argtypes is None:
        lib.window_replay_f32.argtypes = [_P, _I, _I, _F, _P, _P, _P, _P,
                                          _P, _P, _P, _I, _P]
        lib.window_replay_f32.restype = _I
        lib.window_rounds_f32.argtypes = [_P, _I, _I, _F, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _P, _P]
        lib.window_rounds_f32.restype = _I
    return lib


def _field(name: str, grid: TsdGrid) -> torch.Tensor:
    tsd = grid.tsd
    if tsd.dtype != torch.float32 or not tsd.is_contiguous():
        raise TypeError(f"{name}: the kernel takes a contiguous float32 "
                        f"field, got {tsd.dtype}")
    return tsd


def _flat(name: str, dev, tensors) -> Dict[str, torch.Tensor]:
    """The float32 inputs, checked and contiguous: (label, tensor, numel)."""
    flat = {}
    for label, t, numel in tensors:
        if t.device != dev or t.dtype != torch.float32 or t.numel() != numel:
            raise TypeError(f"{name}: {label} must be float32 with {numel} "
                            f"elements on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
        flat[label] = t.contiguous()
    return flat


def window_replay(grid: TsdGrid, k: torch.Tensor, ray: torch.Tensor,
                  idx_min: torch.Tensor, idx_max: torch.Tensor,
                  active: torch.Tensor, tr: torch.Tensor) -> torch.Tensor:
    """[N, 8] per beam: hit, any_ev, pos_x, pos_y, interp, nx, ny, n_ok
    for the window around the candidate step k (see window_replay_plain);
    zeros for an inactive beam."""
    if not grid.tsd.is_cuda:
        return window_replay_plain(grid, k, ray, idx_min, idx_max, active,
                                   tr)
    tsd = _field("window_replay", grid)
    dev = tsd.device
    H, W = tsd.shape
    N = k.shape[0]
    f = _flat("window_replay", dev, (
        ("k", k, N), ("ray", ray, 2 * N), ("idx_min", idx_min, N),
        ("idx_max", idx_max, N), ("tr", tr, 2)))
    if (active.device != dev or active.dtype != torch.bool
            or active.numel() != N):
        raise TypeError(f"window_replay: active must be bool [{N}] on {dev}")
    active = active.contiguous()
    out = torch.empty((N, 8), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.window_replay_f32(
            tsd.data_ptr(), H, W, grid.cell_size, f["k"].data_ptr(),
            f["ray"].data_ptr(), f["idx_min"].data_ptr(),
            f["idx_max"].data_ptr(), active.data_ptr(), f["tr"].data_ptr(),
            out.data_ptr(), N, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"window_replay_f32 launch failed: cudaError {err}")
    window_replay.launches += 1
    return out


window_replay.launches = 0


def window_rounds(grid: TsdGrid, S: torch.Tensor, lev: torch.Tensor,
                  ray: torch.Tensor, idx_min: torch.Tensor,
                  idx_max: torch.Tensor, tr: torch.Tensor, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rounds 2..ROUNDS of the caster on the per-beam state S [N, 8] with
    the candidate levels lev [N, ROUNDS-1] (see window_rounds_plain).
    Returns (S after the rounds, the int64 count of beams that needed a
    round beyond its `cap` replays).  On the card S is updated in place and
    returned; use the result, not the argument."""
    if not grid.tsd.is_cuda:
        return window_rounds_plain(grid, S, lev, ray, idx_min, idx_max, tr,
                                   cap)
    tsd = _field("window_rounds", grid)
    dev = tsd.device
    H, W = tsd.shape
    N, n_rounds = lev.shape
    f = _flat("window_rounds", dev, (
        ("S", S, 8 * N), ("lev", lev, N * n_rounds), ("ray", ray, 2 * N),
        ("idx_min", idx_min, N), ("idx_max", idx_max, N), ("tr", tr, 2)))
    if not S.is_contiguous():
        raise ValueError("window_rounds: S is updated in place and must be "
                         "contiguous")
    if not 0 < cap <= MAX_CAP:
        raise ValueError(f"window_rounds: cap {cap} is outside 1..{MAX_CAP} "
                         "(the kernel lists a round's beams in shared "
                         "memory)")
    dropped = torch.empty((), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.window_rounds_f32(
            tsd.data_ptr(), H, W, grid.cell_size, S.data_ptr(),
            f["lev"].data_ptr(), f["ray"].data_ptr(),
            f["idx_min"].data_ptr(), f["idx_max"].data_ptr(),
            f["tr"].data_ptr(), N, n_rounds, cap, dropped.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"window_rounds_f32 launch failed: cudaError {err}")
    window_rounds.launches += 1
    return S, dropped


window_rounds.launches = 0
