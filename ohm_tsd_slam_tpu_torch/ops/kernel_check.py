"""The fast caster's five CUDA kernels held against their plain twins on
the card, at the inputs the caster itself gives them.

`KernelCheck().kernels` is a grid/raycast_fast.py::CasterKernels whose
every member launches its kernel, runs the twin on the same inputs,
records the disagreement, raises past the tolerance, and returns the
kernel's result.  `extract_segments(grid, kernels=check.kernels)` and
`raycast_fast(..., kernels=check.kernels)` then drive the kernel path
with the check at every call, the candidate rounds included.  Used by
chip_smoke.py and tests/test_torch_raycast_kernels.py.

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
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    CasterKernels,
    cuda_kernels,
    pack_rows_plain,
    segment_layers_plain,
    segment_min_plain,
    window_replay_plain,
)

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
                                     self._compact_channels)

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

    def _window_replay(self, grid, tw0, ray, idx_max, active, tr):
        out = self._k.window_replay(grid, tw0, ray, idx_max, active, tr)
        out_p = window_replay_plain(grid, tw0, ray, idx_max, active, tr)
        flags = [0, 1, 7]                       # hit, any_ev, n_ok
        same = torch.equal(out[:, flags], out_p[:, flags])
        ev = out_p[:, 1] > 0.0
        nrm = ev & (out_p[:, 7] > 0.0)
        e_pos = _max((out[ev, 2:4] - out_p[ev, 2:4]).abs())
        e_int = _max((out[ev, 4] - out_p[ev, 4]).abs())
        e_nrm = _max((out[nrm, 5:7] - out_p[nrm, 5:7]).abs())
        self._note("window_replay", max(e_pos, e_int, e_nrm),
                   same and e_pos <= POS_TOL and e_int <= INTERP_TOL
                   and e_nrm <= NORMAL_TOL,
                   events=int(ev.sum()),
                   hits=int((out_p[:, 0] > 0).sum()))
        return out

    def _compact_channels(self, mask, channels, size):
        packed, total = self._k.compact_channels(mask, channels, size)
        packed_p, total_p = pack_channels_rows(mask, tuple(channels), size)
        err = bit_mismatch(packed, packed_p)
        self._note("compact_channels", err,
                   err == 0.0 and int(total) == int(total_p),
                   segments=int(total_p))
        return packed, total


def bit_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """0.0 when the float32 tensors agree in every bit (NaN payloads and
    signed zeros included), else the largest |a - b| where they differ
    (inf where that is not a number)."""
    differ = a.view(torch.int32) != b.view(torch.int32)
    if not bool(differ.any()):
        return 0.0
    gap = torch.nan_to_num((a - b).abs(), nan=float("inf"))
    return max(float(gap[differ].max()), float(torch.finfo(a.dtype).tiny))
