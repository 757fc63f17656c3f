"""What decides a run's `correct`: the program's outputs in the window
against the plain reference (slambench/reference/), computed after the
window from the same scans and seed.

The reference follows the program step by step from the program's own
state, because a whole window replayed eagerly from the start would take
far longer than the window.  So it checks:

  * the start by itself: the grid after every robot's first scan
    (footprints freed, the first scan pushed), worked out from nothing
    and held against the program's;
  * a sample of the window's scans, drawn from the seed: from the grid,
    pose and last mapped pose the program held before the scan, the
    reference's step (exact march, the robot's RANSAC seed in modes EXP,
    PDF and TSD, ICP, the gates) against the pose the program returned;
    its gates on the program's pose against whether the program mapped
    the scan; and, where it did, the reference's push of the scan at the
    program's pose against the program's next grid;
  * in live cells, a sample of the window's publications: the occupancy
    grid and the colour image of the grid published, against the
    program's messages.

Each number is compared with a limit of its own, kept per cell in
limits/<cell>.json.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from slambench.reference import grid as G
from slambench.reference import slam as R

# a map cell written on one side and unwritten on the other reads as this
# gap (|tsd| <= 1 wherever it is written)
NAN_GAP = 2.0
# the numbers compared, in the order they are printed
NAMES = ("pose_gap_m", "gate_mismatches", "map_gap", "publish_cells")
# the pose gap is the median over the sampled scans: ICP carries
# the caster's rounding into the pose by the scene's conditioning, and the
# widest gap of a sample swings from seed to seed (PERF.md, "correct")


@dataclass
class ScanSample:
    """What the program held and returned around one scan."""

    robot: int
    k: int                   # the scan's index in the robot's stream
    count: int               # the robot's localized scans before it
    grid_before: Any         # the grid's arrays (harness.HostGrid)
    pose_before: torch.Tensor
    last_before: torch.Tensor
    grid_after: Any = None   # None where the program did not map the scan
    pose_after: Optional[torch.Tensor] = None
    nan_pose: bool = False


@dataclass
class PublishSample:
    grid: Any
    occupancy: np.ndarray
    image: Optional[np.ndarray]


@dataclass
class Evidence:
    """Everything the check reads: the program's state and outputs."""

    params: dict
    seed: int
    ranges: List[np.ndarray]          # each robot's scans
    angle_min: float
    increment: float
    start_grid: Any = None
    scans: List[ScanSample] = field(default_factory=list)
    publishes: List[PublishSample] = field(default_factory=list)


def _grid(dep: R.Deployment, g, device) -> G.Grid:
    """The program's grid arrays on `device`, under the reference's own
    settings."""
    ref = G.create(dep.map_size, dep.cell_size, dep.truncation_radius,
                   g.tsd.dtype, "meta")
    return G.Grid(tsd=g.tsd.to(device), weight=g.weight.to(device),
                  tile_init=g.tile_init.to(device),
                  tile_initw=g.tile_initw.to(device),
                  cell_size=ref.cell_size,
                  max_truncation=ref.max_truncation,
                  max_weight=ref.max_weight, tile_dim=ref.tile_dim)


def map_gap(a, b) -> float:
    """The largest gap of tsd or weight between two grids; a cell written
    in one and not the other, or a tile materialized in one only, reads
    NAN_GAP."""
    if not torch.equal(a.tile_init, b.tile_init):
        return NAN_GAP
    gap = 0.0
    for x, y in ((a.tsd, b.tsd), (a.weight, b.weight)):
        nx, ny = torch.isnan(x), torch.isnan(y)
        if bool((nx != ny).any()):
            return NAN_GAP
        d = torch.where(nx, 0.0, (x - y).abs())
        gap = max(gap, float(d.max()))
    gap = max(gap, float((a.tile_initw - b.tile_initw).abs().max()))
    return gap


def readings(ev: Evidence, device, control: Optional[str] = None) -> dict:
    """The compared numbers of one run: the program's outputs against the
    reference's.  With `control` ("tf32": TF32 matrix products; "bf16":
    bfloat16 throughout), the reference computed in that lower precision
    takes the program's place, and must fail."""
    dep = R.deployment(ev.params)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        return _readings(ev, dep, torch.float32, device, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _lower(control: Optional[str], g: G.Grid) -> G.Grid:
    if control != "bf16":
        return g
    return G.Grid(**{**g.__dict__, **{k: getattr(g, k).to(torch.bfloat16)
                                      for k in ("tsd", "weight",
                                                "tile_initw")}})


def _readings(ev: Evidence, dep: R.Deployment, dtype, device,
              control: Optional[str]) -> dict:
    out = dict.fromkeys(NAMES, 0.0)
    out["gate_mismatches"] = 0
    out["publish_cells"] = 0
    pose_gaps = []
    low = torch.bfloat16 if control == "bf16" else dtype
    beams = len(ev.ranges[0][0])
    sensors = [R.sensor(rb, beams, ev.angle_min, ev.increment)
               for rb in dep.robots]

    def ref_step(s: ScanSample, lower: bool) -> tuple:
        robot, sen = dep.robots[s.robot], sensors[s.robot]
        t = low if lower else dtype
        torch.backends.cuda.matmul.allow_tf32 = lower and control == "tf32"
        data, mask = R.preprocess(sen, robot, ev.ranges[s.robot][s.k], t,
                                  device)
        gen = torch.Generator(device=device)
        gen.manual_seed(R.draw_seed(ev.seed, s.robot, s.count))
        before = _grid(dep, s.grid_before, device)
        if lower:
            before = _lower(control, before)
        st = R.step(dep, robot, sen, before, s.pose_before.to(t),
                    s.last_before.to(t), data, mask, gen)
        after = (G.push(before, sen, st.pose, data, mask)
                 if bool(st.significant) else None)
        torch.backends.cuda.matmul.allow_tf32 = False
        return st, after

    if ev.start_grid is not None:
        ref = R.start(dep, [r[0] for r in ev.ranges], ev.angle_min,
                      ev.increment, dtype, device)
        got = (_grid(dep, ev.start_grid, device) if control is None else
               R.start(dep, [r[0] for r in ev.ranges], ev.angle_min,
                       ev.increment, low, device))
        out["map_gap"] = map_gap(got, ref)
    for s in ev.scans:
        robot, sen = dep.robots[s.robot], sensors[s.robot]
        st, _ = ref_step(s, lower=False)
        if control is None:
            pose, nan = s.pose_after, s.nan_pose
            mapped = s.grid_after is not None
            after = _grid(dep, s.grid_after, device) if mapped else None
        else:
            ctl, after = ref_step(s, lower=True)
            pose, nan = ctl.pose.to(dtype), bool(ctl.reg_error)
            mapped = after is not None
        if bool(st.reg_error) != nan:
            out["gate_mismatches"] += 1
        if not nan:
            pose_gaps.append(float(torch.linalg.vector_norm(
                pose[:2, 2] - st.pose[:2, 2])))
            if bool(R.significant(robot, s.last_before, pose)) != mapped:
                out["gate_mismatches"] += 1
        if mapped:
            data, mask = R.preprocess(sen, robot, ev.ranges[s.robot][s.k],
                                      dtype, device)
            ref = G.push(_grid(dep, s.grid_before, device), sen, pose, data, mask)
            out["map_gap"] = max(out["map_gap"], map_gap(after, ref))
    if pose_gaps:
        out["pose_gap_m"] = float(np.median(pose_gaps))
    out["widest_pose_gap_m"] = max(pose_gaps, default=0.0)
    for p in ev.publishes:
        g = _grid(dep, p.grid, device)
        occ = G.occupancy(g, dep.inflation)
        img = G.color_image(g) if p.image is not None else None
        if control is None:
            got_occ, got_img = p.occupancy, p.image
        else:
            gl = _lower(control, g)
            got_occ = G.occupancy(gl, dep.inflation).cpu().numpy()
            got_img = (G.color_image(gl).cpu().numpy()
                       if img is not None else None)
        out["publish_cells"] += int((occ.cpu().numpy() != got_occ).sum())
        if img is not None:
            out["publish_cells"] += int(
                (img.cpu().numpy() != got_img).any(-1).sum())
    return out


def verdict(values: dict, limits: dict) -> bool:
    return all(values[k] <= limits[k] for k in NAMES)


def report(values: dict, limits: dict) -> dict:
    return {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
