"""Write slambench/traffic/scenes/site.json: the warehouse hall of the
double-laser-site deployment (map_size 12: a 102.4 m grid of 0.025 m
cells), as a laser mounted 0.2 m above the floor sees it.

    python tools/site_scene.py [--out PATH]

Every dimension is a constant below and is written into the scene's
`about`.  The hall is 90 x 90 m, centred on the grid's centre (51.2,
51.2).  Selective pallet racking runs north-south in two blocks, either
side of a main cross-aisle through the robots' start line y = 51.2:
back-to-back double rows (two 1.1 m frames and a 0.4 m flue) between
3.0 m aisles, a single row at each side aisle.  In the laser's plane a
rack is its uprights (0.1 m posts at the ends of each 2.7 m beam, front
and back of each frame) and the loads of the pallets stored on the floor
(the first beam level is above the plane): three Euro pallets a bay, as
one 2.55 m x 1.2 m block where the bay's floor positions are taken, a
share of the bays drawn once from a fixed seed.  Building columns stand
in the flues.  Marshalling areas with lanes of staged pallets lie between
the rack ends and the dock walls north and south.  Two circuits run from the start line east along the main
cross-aisle, round the north or the south block through the side and
marshalling areas, and back along the main cross-aisle, keeping
CLEARANCE_M from every object (slambench/tests/test_slambench_site.py
holds them to it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "slambench", "traffic", "scenes", "site.json")

CENTRE = 51.2            # the grid's centre (map_size 12, 0.025 m cells)
HALL = 90.0              # the hall's side
X0, X1 = CENTRE - HALL / 2, CENTRE + HALL / 2
AISLE = 3.0              # between rack faces
FRAME = 1.1              # frame depth (a single row's)
FLUE = 0.4               # between the frames of a double row
DOUBLE = 2 * FRAME + FLUE
PITCH = AISLE + DOUBLE   # aisle centre to aisle centre
POST = 0.1               # upright section
BEAM = 2.7               # clear width of a bay
BAYS = 9                 # bays along a row
ROW_LEN = BAYS * (BEAM + POST) + POST
PALLET_DEPTH = 1.2       # a load overhangs its 1.1 m frame by 0.05 m
LOAD_LEN = 3 * 0.8 + 2 * 0.075      # three pallets with their gaps
MAIN_AISLE = 5.0         # the cross-aisle through the start line
# the marshalling areas between the rack ends and the dock walls (north
# and south), and the staged pallet lanes in front of their dock doors
DOCK_AREA = HALL / 2 - MAIN_AISLE / 2 - ROW_LEN
LANES = 12               # lanes of staged pallets a dock wall
LANE_W, LANE_LEN = 1.2, 4.0         # a lane: five pallets 1.2 m x 0.8 m
LANE_X0 = 18.4           # the first lane's centre; the others at PITCH
LANE_WALL = 1.0          # from a lane's end to the dock wall
FULL_SHARE = 0.4         # chance that a bay's floor positions hold pallets
SEED = 2026
COLUMN_R = 0.12          # building columns, in the flues
CLEARANCE_M = 0.3
TURN = 1.2               # the circuits' turn radius
# the aisle west of the start line; the others follow at PITCH
AISLE_W = CENTRE - 2.8


def aisle_centres():
    """Every aisle's centre: AISLE_W + k PITCH between the side aisles."""
    ks = range(-6, 8)
    return [AISLE_W + k * PITCH for k in ks]


def _rows():
    """(x_min, x_max, kind) of every rack row across the hall: the
    double rows between neighbouring aisles, a single row outside the
    first and last aisle."""
    a = aisle_centres()
    rows = [(a[0] - AISLE / 2 - FRAME, a[0] - AISLE / 2, "single")]
    for left, right in zip(a, a[1:]):
        rows.append((left + AISLE / 2, right - AISLE / 2, "double"))
    rows.append((a[-1] + AISLE / 2, a[-1] + AISLE / 2 + FRAME, "single"))
    return rows


def _blocks():
    """(y_min, y_max) of the north and south rack blocks."""
    north0 = CENTRE + MAIN_AISLE / 2
    south1 = CENTRE - MAIN_AISLE / 2
    return [(north0, north0 + ROW_LEN), (south1 - ROW_LEN, south1)]


def build() -> dict:
    rng = np.random.default_rng(SEED)
    circles, rects = [], []
    r = POST / 2
    for y0, y1 in _blocks():
        frames = [y0 + i * (BEAM + POST) for i in range(BAYS + 1)]
        for x0, x1, kind in _rows():
            faces = ([(x0, x1)] if kind == "single" else
                     [(x0, x0 + FRAME), (x1 - FRAME, x1)])
            for f0, f1 in faces:
                for fy in frames:        # the frame's two uprights
                    for ux in (f0 + r, f1 - r):
                        circles.append([ux, fy + r, r])
                for fy in frames[:-1]:
                    if rng.random() >= FULL_SHARE:
                        continue
                    ly0 = fy + POST + (BEAM - LOAD_LEN) / 2
                    # the load overhangs its frame on both sides
                    rects.append([f0 - 0.05, ly0, f0 - 0.05 + PALLET_DEPTH,
                                  ly0 + LOAD_LEN])
            if kind == "double":
                xc = 0.5 * (x0 + x1)
                for yc in (y0 + 0.3, 0.5 * (y0 + y1), y1 - 0.3):
                    circles.append([xc, yc, COLUMN_R])
    for k in range(LANES):
        xc = LANE_X0 + k * PITCH
        for y_wall, sign in ((X1, -1), (X0, 1)):
            ya = y_wall + sign * LANE_WALL
            yb = ya + sign * LANE_LEN
            rects.append([xc - LANE_W / 2, min(ya, yb), xc + LANE_W / 2,
                          max(ya, yb)])
    rects.insert(0, [X0, X0, X1, X1])
    n_posts = sum(1 for c in circles if c[2] == r)
    n_bays = 2 * BAYS * sum(1 if k == "single" else 2 for *_, k in _rows())
    n_full = len(rects) - 1 - 2 * LANES
    # the circuits: along the main cross-aisle to a side aisle, along it
    # into a marshalling area, across the hall, back along the other side
    # aisle and the main cross-aisle
    a = aisle_centres()
    east = 0.5 * (a[-1] + AISLE / 2 + FRAME + X1)
    west = 0.5 * (a[0] - AISLE / 2 - FRAME + X0)
    across = east - west - 2 * TURN
    lead = east - TURN - CENTRE
    back = CENTRE + MAIN_AISLE / 2 + ROW_LEN + DOCK_AREA / 2
    side = back - TURN - (CENTRE + TURN)

    def loop(sign):
        legs = [["straight", lead], ["arc", TURN, 90 * sign],
                ["straight", side], ["arc", TURN, 90 * sign],
                ["straight", across], ["arc", TURN, 90 * sign],
                ["straight", side], ["arc", TURN, 90 * sign],
                ["straight", across - lead]]
        return {"start": [CENTRE, CENTRE, 0.0],
                "legs": [[leg[0]] + [round(v, 6) for v in leg[1:]]
                         for leg in legs]}

    about = (
        f"A {HALL:g} m x {HALL:g} m warehouse hall (walls x, y in "
        f"[{X0:g}, {X1:g}]) centred on the 102.4 m grid of map_size 12, as "
        f"a laser 0.2 m above the floor sees it. Selective pallet racking "
        f"runs north-south in two blocks of {ROW_LEN:g} m either side of a "
        f"{MAIN_AISLE:g} m main cross-aisle through the start line y = "
        f"{CENTRE:g}: back-to-back double rows ({FRAME:g} m frames, "
        f"{FLUE:g} m flue) between {AISLE:g} m aisles at a {PITCH:g} m "
        f"pitch, aisle centres at {AISLE_W:g} + k {PITCH:g} m (k = -6..7), "
        f"and a single row outside the first and last aisle, beside side "
        f"aisles of {a[0] - AISLE / 2 - FRAME - X0:g} m. In the laser's "
        f"plane a rack is its uprights ({POST:g} m posts at each end of "
        f"every {BEAM:g} m bay, {BAYS} bays a row, front and back of each "
        f"frame: {n_posts} posts) and the loads of the pallets stored on "
        f"the floor, the first beam level being above the plane: three "
        f"0.8 m Euro pallets with 0.075 m gaps a bay, one {LOAD_LEN:g} m x "
        f"{PALLET_DEPTH:g} m block overhanging the frame by 0.05 m, in "
        f"{n_full} of the {n_bays} bays (floor positions taken with a "
        f"chance of {FULL_SHARE:g}, drawn with seed {SEED}). Building "
        f"columns of {COLUMN_R:g} m radius stand in the flues at both ends "
        f"and the middle of each double row. Between the rack ends and the "
        f"dock walls north and south lie {DOCK_AREA:g} m marshalling areas, "
        f"each with {LANES} lanes of staged pallets ({LANE_W:g} m x "
        f"{LANE_LEN:g} m, {LANE_WALL:g} m from the wall, centres at x = "
        f"{LANE_X0:g} + k {PITCH:g} m) before its dock doors. Two circuits "
        f"run through the start line, east along the main cross-aisle "
        f"{lead:g} m to the side aisle at x = {east:g}, there ({TURN:g} m "
        f"turns) north or south {side:g} m into the marshalling area at "
        f"y = {back:g} or {2 * CENTRE - back:g}, west {across:g} m to the "
        f"side aisle at x = {west:g} and back: 'north' and 'south'; each "
        f"keeps {CLEARANCE_M:g} m or more from every object. Written by "
        f"tools/site_scene.py.")
    return {"about": about, "rects": [[round(v, 6) for v in x]
                                      for x in rects],
            "segments": [],
            "circles": [[round(v, 6) for v in c] for c in circles],
            "clearance_m": CLEARANCE_M,
            "loops": {"north": loop(1), "south": loop(-1)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    scene = build()
    with open(args.out, "w") as f:
        json.dump(scene, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
