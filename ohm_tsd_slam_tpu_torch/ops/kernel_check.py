"""The fast caster's CUDA kernels held against their plain twins on the
card, at the inputs the caster itself gives them.

`KernelCheck().kernels` is a grid/raycast_fast.py::CasterKernels whose
every member launches its kernel, runs the twin on the same inputs,
records the disagreement, raises past the tolerance, and returns the
kernel's result.  `extract_segments(grid, kernels=check.kernels)` and
`raycast_fast(..., kernels=check.kernels)` then drive the kernel path
with the check at every call, the candidate rounds included.  Used by
the port's `cuda` tests (tests/test_torch_raycast_kernels.py,
test_torch_paths_cuda.py and others).

Tolerances: the layer mask, its row counts, the candidates' finite
pattern and the replay's events and flags must be equal; the channel
compaction moves values and must equal its twin in every bit; endpoints and
replay positions within POS_TOL, the sub-cell interpolation within
INTERP_TOL and normals within NORMAL_TOL (the bounds
tests/test_raycast_pallas.py:400-414 holds the Pallas replay to); the
candidate t within T_RTOL relative.  Both sides round every operation in
the same order (ops/_build.py builds without FMA contraction), so the
expected error is 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
from ohm_tsd_slam_tpu_torch.grid.push import next_tile_initw, tile_cull
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    CasterKernels,
    cuda_kernels,
    pack_rows_plain,
    segment_layers_plain,
    segment_min_plain,
    window_replay_plain,
    window_rounds_plain,
)
from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

POS_TOL = 1e-5       # m: segment endpoints, replay positions
INTERP_TOL = 2e-4    # sub-cell interpolation, in steps
NORMAL_TOL = 1e-4    # unit normals
T_RTOL = 1e-6        # candidate t, relative to max(|t|, 1)


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


class KernelCheck:
    """See the module docstring.  `stats[name]` holds, per kernel, the
    calls compared and the largest error seen; `log` lists the calls in
    order, each with its name, error and what it found (segments, finite
    candidates per level, replay events and hits)."""

    def __init__(self):
        self._k = cuda_kernels()
        self.stats: Dict[str, Dict[str, float]] = {
            name: {"calls": 0, "max_abs_err": 0.0}
            for name in CasterKernels._fields}
        self.log: List[Tuple[str, float, dict]] = []
        self.kernels = CasterKernels(self._segment_layers, self._pack_rows,
                                     self._segment_min, self._window_replay,
                                     self._compact_channels,
                                     self._window_rounds)

    def _note(self, name: str, err: float, ok: bool, **found) -> None:
        st = self.stats[name]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        self.log.append((name, err, found))
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"twin: {st} {found}")

    def _segment_layers(self, grid):
        mask, cnt = self._k.segment_layers(grid)
        mask_p, cnt_p = segment_layers_plain(grid)
        err = _max((mask - mask_p).abs())
        self._note("segment_layers", err,
                   err == 0.0 and torch.equal(cnt, cnt_p))
        return mask, cnt

    def _pack_rows(self, grid, mask, row_cnt, size):
        packed, total = self._k.pack_rows(grid, mask, row_cnt, size)
        packed_p, total_p = pack_rows_plain(grid, mask, size)
        err = _max((packed - packed_p).abs())
        self._note("pack_rows", err,
                   int(total) == int(total_p) and err <= POS_TOL,
                   segments=int(total_p))
        return packed, total

    def _segment_min(self, pack, count, ray, lo, hi, t_after, tr,
                     levels=1, cover=0.0):
        out = self._k.segment_min(pack, count, ray, lo, hi, t_after, tr,
                                  levels, cover)
        out_p = segment_min_plain(pack, count, ray, lo, hi, t_after, tr,
                                  levels, cover)
        fin = torch.isfinite(out_p)
        same = torch.equal(fin, torch.isfinite(out))
        d = (out - out_p).abs()[fin]
        rel = _max(d / out_p.abs()[fin].clamp(min=1.0))
        self._note("segment_min", _max(d), same and rel <= T_RTOL,
                   finite=fin.sum(0).tolist())
        return out

    def _rows(self, name: str, out, out_p, rows, ok: bool = True, **found):
        """Note a comparison of replay rows [N, 8] (window_replay_plain's
        layout): flags and NaN pattern equal; over `rows`, positions,
        interpolation and normals within their tolerances."""
        flags = [0, 1, 7]                       # hit, any_ev, n_ok
        same = (torch.equal(out[:, flags], out_p[:, flags])
                and torch.equal(torch.isnan(out[rows]),
                                torch.isnan(out_p[rows])))
        # equal values (inf included) and NaN on both sides differ by 0
        d = torch.nan_to_num(torch.where(out == out_p, 0.0,
                                         (out - out_p).abs()), nan=0.0)[rows]
        e_pos, e_int, e_nrm = _max(d[:, 2:4]), _max(d[:, 4]), _max(d[:, 5:7])
        self._note(name, max(e_pos, e_int, e_nrm),
                   ok and same and e_pos <= POS_TOL and e_int <= INTERP_TOL
                   and e_nrm <= NORMAL_TOL,
                   hits=int((out_p[:, 0] > 0).sum()), **found)

    def _window_replay(self, grid, k, ray, idx_min, idx_max, active, tr,
                       row0=0):
        args = (grid, k, ray, idx_min, idx_max, active, tr)
        out = self._k.window_replay(*args, row0=row0)
        out_p = window_replay_plain(*args, row0=row0)
        ev = out_p[:, 1] > 0.0                  # rows with an event
        self._rows("window_replay", out, out_p, ev, events=int(ev.sum()))
        return out

    def _window_rounds(self, grid, S, lev, ray, idx_min, idx_max, tr, cap):
        # the twin first: the kernel updates S in place.  Every row is
        # compared: a row without an event carries its window's first
        # sample pair on both sides
        S_p, dropped_p = window_rounds_plain(grid, S, lev, ray, idx_min,
                                             idx_max, tr, cap)
        hits_before = int((S[:, 0] > 0).sum())
        out, dropped = self._k.window_rounds(grid, S, lev, ray, idx_min,
                                             idx_max, tr, cap)
        every = torch.ones_like(S_p[:, 0], dtype=torch.bool)
        self._rows("window_rounds", out, S_p, every,
                   ok=int(dropped) == int(dropped_p),
                   new_hits=int((S_p[:, 0] > 0).sum()) - hits_before,
                   finite=torch.isfinite(lev).sum(0).tolist(),
                   dropped=int(dropped_p))
        return out, dropped

    def _compact_channels(self, mask, channels, size):
        packed, total = self._k.compact_channels(mask, channels, size)
        packed_p, total_p = pack_channels_rows(mask, tuple(channels), size)
        err = bit_mismatch(packed, packed_p)
        self._note("compact_channels", err,
                   err == 0.0 and int(total) == int(total_p),
                   segments=int(total_p))
        return packed, total


class PushCheck:
    """ops/push_cuda.py::push_cuda with the kernel's per-tile decisions
    held against grid/push.py::tile_cull and next_tile_initw at every
    call: an instance stands in for push_cuda (slam/mapping.py's
    `_push_fn`).  With a `tile_gate` the twin's decisions are ANDed with
    it, as grid/push.py::push does.  `touch` and `empty_inc` must be equal
    on every tile, `part_weight`, `tile_init` and `tile_initw` equal in
    every value; a mismatch raises.  `stats` counts the calls, the gated
    calls and the tiles their gates pruned, the tiles compared, the tiles
    the pushes touched and emptied, and the mismatching tiles (0 unless a
    call raised)."""

    def __init__(self):
        self.stats: Dict[str, float] = {
            "calls": 0, "gated_calls": 0, "pruned": 0,
            "tiles": 0, "touched": 0, "emptied": 0,
            "touch_flips": 0, "empty_inc_flips": 0,
            "part_weight_mismatches": 0, "part_weight_max_abs_err": 0.0,
            "tile_init_mismatches": 0, "tile_initw_mismatches": 0}

    def __call__(self, grid, geom, pose, data, mask, tile_gate=None, ty0=0):
        cull = torch.empty((grid.tiles_y, grid.tiles_x, 3),
                           dtype=torch.float32, device=grid.tsd.device)
        out = push_cuda(grid, geom, pose, data, mask, tile_gate=tile_gate,
                        cull=cull, ty0=ty0)
        touch, empty_inc, part_weight = tile_cull(
            grid, geom, pose.to(torch.float32), data.to(torch.float32), mask,
            ty0)
        st = self.stats
        if tile_gate is not None:
            touch = touch & tile_gate
            empty_inc = empty_inc & tile_gate
            st["gated_calls"] += 1
            st["pruned"] += int((~tile_gate).sum())
        found = {
            "touch_flips": (cull[..., 0] > 0) != touch,
            "empty_inc_flips": (cull[..., 1] > 0) != empty_inc,
            "part_weight_mismatches": cull[..., 2] != part_weight,
            "tile_init_mismatches": out.tile_init != (grid.tile_init | touch),
            "tile_initw_mismatches":
                out.tile_initw != next_tile_initw(grid, empty_inc)}
        st["calls"] += 1
        st["tiles"] += touch.numel()
        st["touched"] += int(touch.sum())
        st["emptied"] += int(empty_inc.sum())
        st["part_weight_max_abs_err"] = max(
            st["part_weight_max_abs_err"],
            _max((cull[..., 2] - part_weight).abs()))
        bad = {name: int(m.sum()) for name, m in found.items()}
        for name, n in bad.items():
            st[name] += n
        if any(bad.values()):
            raise AssertionError("the push kernel's cull disagrees with "
                                 f"tile_cull on this push: {bad}; {st}")
        return out


def bit_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """0.0 when the float32 tensors agree in every bit (NaN payloads and
    signed zeros included), else the largest |a - b| where they differ
    (inf where that is not a number)."""
    differ = a.view(torch.int32) != b.view(torch.int32)
    if not bool(differ.any()):
        return 0.0
    gap = torch.nan_to_num((a - b).abs(), nan=float("inf"))
    return max(float(gap[differ].max()), float(torch.finfo(a.dtype).tiny))
