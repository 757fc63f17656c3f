"""The one generator of the benchmark's scan streams.

Every cell's scans are made here in its set-up, from `--seed`:

  * the scene (scenes/<name>.json): walls, boxes and pillars as segments
    and circles, and closed circuits ("loops") through the robots' start
    line, each a start pose and legs (straight, or an arc of a radius
    through an angle);
  * each robot's route: every loop of the mix's `circuits` once, from the
    robot's configured start pose, in the order the seed picks, then again
    from the first; a loop is run backwards where the robot's start
    heading points against it.  The robot moves `step_m` a scan along it;
  * each scan's ranges: a vectorised copy of the port's
    utils/testing.py::simulate_scan (float64: the first hit of each beam
    on a segment or circle within max_range, else inf), plus Gaussian
    range noise of the config's sigma, clipped at its published bound,
    drawn from the seed.

The seed changes the order of the same circuits and the noise, never the
amount of work: every seed drives the same paths at the same speed.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
_DENSE_M = 1e-4          # loop sampling when looking for a robot's start
_CHUNK = 256             # scans simulated at once


def load_scene(name: str, scenes_dir: str = SCENES) -> dict:
    with open(os.path.join(scenes_dir, name + ".json")) as f:
        return json.load(f)


def scene_objects(scene: dict):
    """(segments [S, 4] as x0, y0, x1, y1; circles [C, 3] as cx, cy, r),
    a rectangle's four walls in rect_walls' order."""
    segs = []
    for x0, y0, x1, y1 in scene.get("rects", []):
        segs += [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1),
                 (x0, y1, x0, y0)]
    segs += [tuple(s) for s in scene.get("segments", [])]
    return (np.asarray(segs, dtype=np.float64).reshape(-1, 4),
            np.asarray(scene.get("circles", []),
                       dtype=np.float64).reshape(-1, 3))


# ---------------------------------------------------------------- loops

@dataclass(frozen=True)
class Loop:
    """A closed path: its legs' start poses, kinds and lengths."""

    x0: np.ndarray
    y0: np.ndarray
    h0: np.ndarray
    radius: np.ndarray       # 0 for a straight leg
    turn: np.ndarray         # +1 left, -1 right, 0 straight
    length: np.ndarray
    cum: np.ndarray          # arc length at each leg's start

    @property
    def total(self) -> float:
        return float(self.cum[-1] + self.length[-1])

    def at(self, s: np.ndarray):
        """(x, y, heading) at arc lengths s (taken modulo the loop)."""
        s = np.mod(np.asarray(s, dtype=np.float64), self.total)
        i = np.clip(np.searchsorted(self.cum, s, side="right") - 1, 0,
                    len(self.cum) - 1)
        u = s - self.cum[i]
        x0, y0, h0, r, t = (self.x0[i], self.y0[i], self.h0[i],
                            self.radius[i], self.turn[i])
        arc = t != 0
        rr = np.where(arc, r, 1.0)
        h = h0 + np.where(arc, t * u / rr, 0.0)
        cx = x0 - t * rr * np.sin(h0)
        cy = y0 + t * rr * np.cos(h0)
        x = np.where(arc, cx + t * rr * np.sin(h), x0 + u * np.cos(h0))
        y = np.where(arc, cy - t * rr * np.cos(h), y0 + u * np.sin(h0))
        return x, y, h


def make_loop(spec: dict) -> Loop:
    x, y, h = (float(v) for v in spec["start"])
    rows = []
    for leg in spec["legs"]:
        if leg[0] == "straight":
            length = float(leg[1])
            rows.append((x, y, h, 0.0, 0.0, length))
            x += length * math.cos(h)
            y += length * math.sin(h)
        elif leg[0] == "arc":
            r, deg = float(leg[1]), float(leg[2])
            t = 1.0 if deg > 0 else -1.0
            length = r * math.radians(abs(deg))
            rows.append((x, y, h, r, t, length))
            cx, cy = x - t * r * math.sin(h), y + t * r * math.cos(h)
            h += t * length / r
            x, y = cx + t * r * math.sin(h), cy - t * r * math.cos(h)
        else:
            raise ValueError(f"unknown leg {leg!r}")
    sx, sy, sh = (float(v) for v in spec["start"])
    if math.hypot(x - sx, y - sy) > 1e-6 or abs(
            math.remainder(h - sh, 2 * math.pi)) > 1e-6:
        raise ValueError(f"loop does not close: ends at {(x, y, h)}")
    a = np.asarray(rows, dtype=np.float64)
    cum = np.concatenate([[0.0], np.cumsum(a[:, 5])[:-1]])
    return Loop(a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4], a[:, 5], cum)


@dataclass(frozen=True)
class Leg:
    """One loop of a robot's route: where on it the robot enters, and in
    which direction it runs it."""

    loop: Loop
    s0: float
    forward: bool

    def at(self, u: np.ndarray):
        s = self.s0 + u if self.forward else self.s0 - u
        x, y, h = self.loop.at(s)
        return x, y, (h if self.forward else h + math.pi)


def enter(loop: Loop, x: float, y: float, yaw: float) -> Leg:
    """Where a robot at (x, y) facing yaw joins `loop`, and the direction
    it runs it.  Raises where the pose is not on the loop."""
    s = np.arange(0.0, loop.total, _DENSE_M)
    lx, ly, lh = loop.at(s)
    d = np.hypot(lx - x, ly - y)
    for forward, heading in ((True, lh), (False, lh + math.pi)):
        ok = np.cos(heading - yaw) > 0.9999
        if ok.any():
            i = int(np.argmin(np.where(ok, d, np.inf)))
            if d[i] < 1e-3:
                # one projection onto the tangent: exact on a straight leg
                s0 = s[i] + ((x - lx[i]) * math.cos(lh[i])
                             + (y - ly[i]) * math.sin(lh[i]))
                return Leg(loop, float(s0), forward)
    raise ValueError(f"start pose {(x, y, yaw)} lies on no loop")


def route(legs: Sequence[Leg], n: int, step: float) -> np.ndarray:
    """[n, 3] poses (x, y, heading): `step` apart along the legs, one
    after the other, then from the first again."""
    total = sum(leg.loop.total for leg in legs)
    u = np.mod(np.arange(n, dtype=np.float64) * step, total)
    out = np.zeros((n, 3))
    base = 0.0
    for leg in legs:
        sel = (u >= base) & (u < base + leg.loop.total)
        out[sel] = np.stack(leg.at(u[sel] - base), axis=1)
        base += leg.loop.total
    return out


# ---------------------------------------------------------------- ranges

def simulate(poses: torch.Tensor, beams: int, res: float, phi_min: float,
             max_range: float, segments: np.ndarray,
             circles: np.ndarray) -> torch.Tensor:
    """[N, beams] float64 ranges of the scans from poses [N, 3] (x, y,
    heading) on the poses' device: simulate_scan's arithmetic for every
    beam of every scan at once, inf where no object lies within
    max_range."""
    dev = poses.device
    f64 = torch.float64
    phi = phi_min + torch.arange(beams, dtype=f64, device=dev) * res
    dl0, dl1 = torch.cos(phi), torch.sin(phi)
    out = []
    for p in poses.to(f64).split(_CHUNK):
        c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
        dx = c * dl0 - s * dl1
        dy = s * dl0 + c * dl1
        ox, oy = p[:, 0:1], p[:, 1:2]
        best = torch.full_like(dx, math.inf)
        for ax, ay, bx, by in segments.tolist():
            ex, ey = bx - ax, by - ay
            denom = dx * ey - dy * ex
            t = ((ax - ox) * ey - (ay - oy) * ex) / denom
            u = ((ax - ox) * dy - (ay - oy) * dx) / denom
            hit = (denom.abs() >= 1e-15) & (t > 0) & (u >= 0.0) & (u <= 1.0)
            best = torch.minimum(best, torch.where(hit, t, math.inf))
        for cx, cy, r in circles.tolist():
            fx, fy = ox - cx, oy - cy
            a = dx * dx + dy * dy
            b = 2 * (fx * dx + fy * dy)
            cc = fx * fx + fy * fy - r * r
            disc = b * b - 4 * a * cc
            sq = torch.sqrt(disc.clamp(min=0.0))
            t1 = (-b - sq) / (2 * a)
            t2 = (-b + sq) / (2 * a)
            t = torch.where(t1 > 0, t1, torch.where(t2 > 0, t2, math.inf))
            best = torch.minimum(best, torch.where(disc >= 0, t, math.inf))
        out.append(torch.where(best <= max_range, best, math.inf))
    return torch.cat(out)


def add_noise(ranges: torch.Tensor, sigma: float, clip: float,
              gen: torch.Generator) -> torch.Tensor:
    """Gaussian range noise of `sigma`, clipped to ±clip, on the returns."""
    noise = (torch.randn(ranges.shape, generator=gen, dtype=ranges.dtype,
                         device=ranges.device) * sigma).clamp(-clip, clip)
    return torch.where(torch.isinf(ranges), ranges, ranges + noise)


# ---------------------------------------------------------------- a stream

@dataclass
class Stream:
    """Each robot's scans (ranges [n, beams] float64 on the host) and the
    true poses they were taken from ([n, 3])."""

    ranges: List[np.ndarray]
    truth: List[np.ndarray]
    circuits: List[List[str]]


def make_stream(starts: Sequence[tuple], max_ranges: Sequence[float],
                scanner: dict, scene_name: str, circuits: Sequence[str],
                mix: dict, n: int, seed: int, device,
                scenes_dir: str = SCENES) -> Stream:
    """`n` scans a robot from `seed`: robot r starts at starts[r] (x, y,
    yaw) with a laser of max_ranges[r] and drives the scene's `circuits`,
    `mix["step_m"]` a scan."""
    scene = load_scene(scene_name, scenes_dir)
    segs, circles = scene_objects(scene)
    loops = {k: make_loop(v) for k, v in scene["loops"].items()}
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    res = math.radians(scanner["increment_deg"])
    phi_min = math.radians(scanner["angle_min_deg"])
    out = Stream([], [], [])
    for (x, y, yaw), max_range in zip(starts, max_ranges):
        order = [str(c) for c in rng.permutation(list(circuits))]
        legs = [enter(loops[c], x, y, yaw) for c in order]
        truth = route(legs, n, mix["step_m"])
        ranges = simulate(torch.as_tensor(truth, device=device),
                          scanner["beams"], res, phi_min, max_range, segs,
                          circles)
        ranges = add_noise(ranges, scanner["noise_sigma_m"],
                           scanner["noise_clip_m"], gen)
        out.ranges.append(ranges.cpu().numpy())
        out.truth.append(truth)
        out.circuits.append(order)
    return out
