"""Exact-march window replay with crossing normals on the card: the
wrappers of csrc/window_replay.cu (kernel D of the fast caster).

Replaces the TPU kernels ohm_tsd_slam_tpu/ops/window_block_pallas.py::
window_block_pallas and window_single_pallas.  The source has two entry
points: `window_replay` replays every beam's first candidate window (round
1, eight lanes a beam), `window_rounds` runs rounds 2..ROUNDS on the
per-beam state in one launch (selection, replay and update in place; one
block up to ONE_BLOCK_BEAMS beams, else a cooperative launch over the
card: window_rounds_blocks).  `tr` is a table of P sensor translations
[P, 2] (one scan: [2] or [1, 2]); the beams of pose p are the p-th of P
equal runs of the beam axis (grid/raycast_fast.py::raycast_fast_batch).
Their plain versions are grid/raycast_fast.py::window_replay_plain and
window_rounds_plain; a wrapper runs its plain version for a grid on the
CPU.  For a grid on CUDA it launches the kernel or raises;
`window_replay.launches` and `window_rounds.launches` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

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

# the one-block rounds kernel lists a round's beams in static-limit shared
# memory
MAX_CAP = 48 * 1024 // 4
# the most beams the rounds take in one block; more take a cooperative
# launch of a block for each ROUNDS_THREADS beams (window_rounds_blocks).
# The crossover on an H100 (tools/torch_kernel_times.py::rounds_crossover):
# one block is the faster at 3243 beams, the cooperative launch at 4324
ONE_BLOCK_BEAMS = 3584
ROUNDS_THREADS = 1024        # csrc/window_replay.cu::kRoundsThreads


def _lib() -> ctypes.CDLL:
    lib = _build.load("window_replay")
    if lib.window_replay_f32.argtypes is None:
        lib.window_replay_f32.argtypes = [_P, _I, _I, _I, _F, _P, _P, _P,
                                          _P, _P, _P, _P, _I, _I, _P]
        lib.window_replay_f32.restype = _I
        lib.window_rounds_f32.argtypes = [_P, _I, _I, _F, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _I,
                                          _P, _P, _P]
        lib.window_rounds_f32.restype = _I
        lib.window_rounds_resident_blocks.argtypes = []
        lib.window_rounds_resident_blocks.restype = _I
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


def _poses(name: str, tr: torch.Tensor, N: int) -> int:
    """The rows P of the translation table `tr` ([2] is one row); the N
    beams must split into P equal runs."""
    P = max(tr.numel() // 2, 1)
    if N % P:
        raise ValueError(f"{name}: {N} beams do not split into {P} poses")
    return P


def window_replay(grid: TsdGrid, k: torch.Tensor, ray: torch.Tensor,
                  idx_min: torch.Tensor, idx_max: torch.Tensor,
                  active: torch.Tensor, tr: torch.Tensor,
                  row0: int = 0) -> torch.Tensor:
    """[N, 8] per beam: hit, any_ev, pos_x, pos_y, interp, nx, ny, n_ok
    for the window around the candidate step k (see window_replay_plain);
    zeros for an inactive beam.  `grid` may be a row block whose row 0 is
    world row `row0` (parallel/shard_raycast.py)."""
    if not grid.tsd.is_cuda:
        return window_replay_plain(grid, k, ray, idx_min, idx_max, active,
                                   tr, row0=row0)
    tsd = _field("window_replay", grid)
    dev = tsd.device
    H, W = tsd.shape
    N = k.shape[0]
    P = _poses("window_replay", tr, N)
    f = _flat("window_replay", dev, (
        ("k", k, N), ("ray", ray, 2 * N), ("idx_min", idx_min, N),
        ("idx_max", idx_max, N), ("tr", tr, 2 * P)))
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
            tsd.data_ptr(), H, W, row0, grid.cell_size, f["k"].data_ptr(),
            f["ray"].data_ptr(), f["idx_min"].data_ptr(),
            f["idx_max"].data_ptr(), active.data_ptr(), f["tr"].data_ptr(),
            out.data_ptr(), N, N // P,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"window_replay_f32 launch failed: cudaError {err}")
    window_replay.launches += 1
    return out


window_replay.launches = 0


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int) -> int:
    """Blocks of the rounds kernel card `device_index` holds at once."""
    with torch.cuda.device(device_index):
        fit = _lib().window_rounds_resident_blocks()
    if fit < 1:
        raise RuntimeError(f"window_rounds_resident_blocks failed: "
                           f"cudaError {-fit}")
    return fit


def window_rounds_blocks(n_beams: int, device=None) -> int:
    """Blocks the rounds kernel takes for n_beams on `device` (the current
    card by default): 1 up to ONE_BLOCK_BEAMS, else a cooperative launch
    of a block for each ROUNDS_THREADS beams, at most as many as the card
    holds at once."""
    if n_beams <= ONE_BLOCK_BEAMS:
        return 1
    index = torch.device(device if device is not None else "cuda").index
    fit = _resident_blocks(torch.cuda.current_device() if index is None
                           else index)
    return max(1, min(-(-n_beams // ROUNDS_THREADS), fit))


def check_cap(cap: int, blocks: int) -> None:
    """The capacity a launch of `blocks` blocks takes: one block lists a
    round's beams in shared memory (at most MAX_CAP), more in a scratch
    tensor of any size."""
    if cap < 1 or (blocks == 1 and cap > MAX_CAP):
        raise ValueError(f"window_rounds: cap {cap} is outside 1.."
                         f"{MAX_CAP if blocks == 1 else 'N'} for {blocks} "
                         "block(s) (one block lists a round's beams in "
                         "shared memory)")


def window_rounds(grid: TsdGrid, S: torch.Tensor, lev: torch.Tensor,
                  ray: torch.Tensor, idx_min: torch.Tensor,
                  idx_max: torch.Tensor, tr: torch.Tensor, cap: int,
                  blocks: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rounds 2..ROUNDS of the caster on the per-beam state S [N, 8] with
    the candidate levels lev [N, ROUNDS-1] (see window_rounds_plain; the
    later columns of a wider tensor are taken as they lie, without a copy).
    Returns (S after the rounds, the int64 count of beams that needed a
    round beyond its `cap` replays).  On the card S is updated in place and
    returned; use the result, not the argument.  One launch whatever N, of
    `blocks` blocks (window_rounds_blocks(N) by default;
    tools/torch_kernel_times.py times other counts against it): one block
    lists in shared memory, more are a cooperative launch with a list and
    block counts in a scratch tensor."""
    if not grid.tsd.is_cuda:
        return window_rounds_plain(grid, S, lev, ray, idx_min, idx_max, tr,
                                   cap)
    tsd = _field("window_rounds", grid)
    dev = tsd.device
    H, W = tsd.shape
    N, n_rounds = lev.shape
    P = _poses("window_rounds", tr, N)
    f = _flat("window_rounds", dev, (
        ("S", S, 8 * N), ("ray", ray, 2 * N), ("idx_min", idx_min, N),
        ("idx_max", idx_max, N), ("tr", tr, 2 * P)))
    if lev.device != dev or lev.dtype != torch.float32 or lev.dim() != 2:
        raise TypeError(f"window_rounds: lev must be float32 [N, rounds] on "
                        f"{dev}, got {lev.dtype} {tuple(lev.shape)} on "
                        f"{lev.device}")
    if lev.stride(1) != 1:
        lev = lev.contiguous()
    if not S.is_contiguous():
        raise ValueError("window_rounds: S is updated in place and must be "
                         "contiguous")
    if blocks is None:
        blocks = window_rounds_blocks(N, dev)
    check_cap(cap, blocks)
    dropped = torch.empty((), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        # the list and a count a block, in global memory, grid-wide only
        scratch = (torch.empty(cap + blocks, dtype=torch.int32, device=dev)
                   if blocks > 1 else None)
        err = lib.window_rounds_f32(
            tsd.data_ptr(), H, W, grid.cell_size, S.data_ptr(),
            lev.data_ptr(), f["ray"].data_ptr(),
            f["idx_min"].data_ptr(), f["idx_max"].data_ptr(),
            f["tr"].data_ptr(), N, n_rounds, lev.stride(0), cap, N // P,
            blocks, None if scratch is None else scratch.data_ptr(),
            dropped.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"window_rounds_f32 launch failed: cudaError {err}")
    window_rounds.launches += 1
    return S, dropped


window_rounds.launches = 0
