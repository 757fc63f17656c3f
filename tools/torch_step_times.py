"""Times of the PyTorch port's SlamNode.process_scan and localize_step on
one CUDA card, the eager step beside the compiled one (localize_step_jit:
CUDA graph replays), on the ICP path (configs/double-laser.yaml's
settings, two robots) and the TSD path (configs/single-laser.yaml's, the
reference's shipped default).  Run it from the root of a checkout:

    python3 tools/torch_step_times.py [--tag NAME] [--out FILE]

It takes the settings, scenes and timers of that checkout's chip_smoke.py,
so a copy in another checkout's tools/ times that tree: a checkout without
localize_step_jit (before the compiled step) is timed eager only.  Copy it into a parent's tree and run parent, change, change,
parent in one call to compare the two on one card.

Per path: one node per variant (eager, inside chip_smoke.py's
eager_step(); compiled, the node as it is) over the same scans, in
turns scan by scan so that a drift of the host's speed falls on both; each
process_scan is timed on the host's clock between two
torch.cuda.synchronize() (the map update it queues included); the first
scan of each robot (initialisation, and the capture's priming on the
compiled node) is reported apart.  Then localize_step on the node's last
grid and pose: CUDA events around each call (chip_smoke.py::time_cuda) and
the host's clock around each call and a synchronize.  Medians and
quartiles are printed with the card's name and power limit; --out writes
every list as JSON.  Then the device memory that each node reserves
over the path run alone (path_memory), its graphs' pools included.  Last,
the overflow scan (overflow_times): the ICP path on the node as it is,
with raycast_fast.MAX_SEGMENTS forced just above the first grid's
segments, so the first scans fit and the growing map overflows; the
process_scan times of the scans that overflow and of those that fit,
apart.  Where the node re-runs an overflowing scan's step eagerly with the
exact march (before the guard went into the step) that is what it times;
with the guard inside the compiled step, the replay.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def has_compiled_step() -> bool:
    from ohm_tsd_slam_tpu_torch.slam import localize

    return hasattr(localize, "localize_step_jit")


def path_scans(cs, cfg, n_scans: int) -> tuple:
    """The trajectory of each robot and its simulated scans."""
    half = cfg.grid.size_meters * 0.5
    gts = [cs.trajectory((half + rc.local_offset_x, half + rc.local_offset_y,
                          rc.local_offset_yaw), n_scans)
           for rc in cfg.robots]
    scans = [[cs.scan_ranges(p, rc.sensor.max_range) for p in gt]
             for gt, rc in zip(gts, cfg.robots)]
    return gts, scans


def step_context(cs, variant):
    """The node's step as the variant asks: eager_step() for False."""
    return cs.eager_step() if variant is False else contextlib.nullcontext()


def time_host(fn, n: int, warmup: int = 3) -> list:
    """ms of each of n calls of fn() on the host's clock, between two
    synchronisations of the card, after a warm-up."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def path_times(cs, dev, flat: dict, n_scans: int, variants) -> dict:
    """process_scan on one node per variant (True: the compiled step,
    False: the eager one, None: the checkout's only step) over the same
    scans, in turns.  Returns per variant the ms of every scan after each
    robot's first, the ms of the first scans, and the node."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(flat)
    _, scans = path_scans(cs, cfg, n_scans)
    out = {v: {"process_scan": [], "first": [], "node": SlamNode(
        cfg, dtype=torch.float32, device=dev)} for v in variants}
    for k in range(n_scans):
        for r, rc in enumerate(cfg.robots):
            msg = cs.scan_msg(scans[r][k], rc.sensor.max_range, float(k))
            for v in variants:
                node = out[v]["node"]
                with step_context(cs, v):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    node.process_scan(r, msg)
                    torch.cuda.synchronize()
                out[v]["process_scan" if k else "first"].append(
                    (time.perf_counter() - t0) * 1e3)
                assert node.localizers[r].rays_dropped == 0, (v, r, k)
    return out


def path_memory(cs, dev, flat: dict, n_scans: int, variant) -> dict:
    """The device memory that one node reserves over the path run alone,
    in MiB above what the process held before it: at the end
    (memory_reserved) and at the peak (max_memory_reserved), and the peak
    allocated.  `variant` as in path_times; for the compiled node the
    graphs of both entry points are dropped first, so that its captures,
    their buffers and their pools fall inside the run."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam import SlamNode, localize

    cfg = from_flat_params(flat)
    _, scans = path_scans(cs, cfg, n_scans)
    if variant:
        localize.localize_step_jit.compiled.clear_cache()
        rf.extract_segments_jit.compiled.clear_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reserved = torch.cuda.memory_reserved(dev)
    allocated = torch.cuda.memory_allocated(dev)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    with step_context(cs, variant):
        for k in range(n_scans):
            for r, rc in enumerate(cfg.robots):
                node.process_scan(r, cs.scan_msg(scans[r][k],
                                                 rc.sensor.max_range,
                                                 float(k)))
    torch.cuda.synchronize()
    out = {"reserved_MiB": (torch.cuda.memory_reserved(dev) - reserved)
           / 2**20,
           "peak_reserved_MiB": (torch.cuda.max_memory_reserved(dev)
                                 - reserved) / 2**20,
           "peak_allocated_MiB": (torch.cuda.max_memory_allocated(dev)
                                  - allocated) / 2**20}
    del node
    gc.collect()
    torch.cuda.empty_cache()
    return out


def overflow_times(cs, dev, flat: dict, n_scans: int) -> tuple:
    """process_scan of the node as it is, every robot in turns, with
    raycast_fast.MAX_SEGMENTS forced to the least multiple of 128 above
    the segments of the grid the path starts from (restored after).
    Returns the capacity and the ms of the scans after each robot's first
    that overflowed ("over") and that did not ("fit")."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(flat)
    _, scans = path_scans(cs, cfg, n_scans)
    probe = SlamNode(cfg, dtype=torch.float32, device=dev)
    with step_context(cs, False):
        probe.process_scan(0, cs.scan_msg(scans[0][0],
                                          cfg.robots[0].sensor.max_range,
                                          0.0))
    cap = 128 * (int(rf.extract_segments(probe.grid).count) // 128 + 1)
    del probe
    saved = rf.MAX_SEGMENTS
    rf.MAX_SEGMENTS = cap
    out = {"over": [], "fit": []}
    try:
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        for k in range(n_scans):
            for r, rc in enumerate(cfg.robots):
                msg = cs.scan_msg(scans[r][k], rc.sensor.max_range, float(k))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                node.process_scan(r, msg)
                torch.cuda.synchronize()
                if k:
                    over = node.localizers[r].rays_dropped > 0
                    out["over" if over else "fit"].append(
                        (time.perf_counter() - t0) * 1e3)
    finally:
        rf.MAX_SEGMENTS = saved
    return cap, out


def step_inputs(cs, node) -> tuple:
    """Robot 0's arguments of localize_step on the node's last grid and
    pose, a fresh scan from that pose, and its draw streams."""
    loc = node.localizers[0]
    pose = loc.pose.contiguous()
    xyt = (float(pose[0, 2]), float(pose[1, 2]),
           math.atan2(float(pose[1, 0]), float(pose[0, 0])))
    data, mask = node._preprocess(loc, cs.scan_ranges(xyt,
                                                      loc.geom.max_range))
    grid = node.grid
    seg = node._segments_for(grid) if node._needs_segments(loc) else None
    draws = iter(range(1 << 30))
    return (grid, pose, loc.last_pose, data, mask, loc.params,
            lambda: node._draws(0, next(draws)), seg)


def step_times(cs, node, n: int, compiled: bool) -> dict:
    """localize_step (and, where the checkout has it, localize_step_jit)
    on step_inputs: ms by CUDA events and by the host's clock."""
    from ohm_tsd_slam_tpu_torch.slam import localize

    grid, pose, last, data, mask, params, gen, seg = step_inputs(cs, node)
    fns = {"eager": localize.localize_step}
    if compiled:
        fns["compiled"] = localize.localize_step_jit
    out = {}
    for how, timer in (("CUDA events", lambda f: cs.time_cuda(f, n)),
                       ("host clock", lambda f: time_host(f, n))):
        for name, fn in fns.items():
            out[f"{name}, {how}"] = timer(
                lambda fn=fn: fn(grid, pose, last, data, mask, params,
                                 generator=gen(), segments=seg))
    return out


def report(name: str, ms: list, label: str) -> None:
    """Median and quartiles, or the values where there are few."""
    if len(ms) < 4:
        print(f"{name}: {', '.join(f'{t:.4f}' for t in ms)} ms [{label}]")
        return
    q1, _, q3 = statistics.quantiles(ms, n=4)
    print(f"{name}: median {statistics.median(ms):.4f} ms, quartiles "
          f"{q1:.4f}-{q3:.4f} ms, n={len(ms)} [{label}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_times: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default=os.path.basename(ROOT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    dev = torch.device("cuda")
    label = cs.card_label()
    compiled = has_compiled_step()
    variants = (False, True) if compiled else (None,)
    names = {False: "eager", True: "compiled", None: "eager"}
    t0 = time.perf_counter()
    lists, memory = {}, {}
    for path, flat, n in (("ICP", cs.DOUBLE_LASER, cs.SCANS_PER_ROBOT),
                          ("TSD", cs.SINGLE_LASER, cs.SCANS_TSD)):
        runs = path_times(cs, dev, flat, n, variants)
        for v in variants:
            for what in ("process_scan", "first"):
                lists[f"{args.tag} {path} {what} {names[v]}"] = runs[v][what]
        node = runs[variants[-1]]["node"]
        for name, ms in step_times(cs, node, cs.N_TIMED, compiled).items():
            lists[f"{args.tag} {path} localize_step {name}"] = ms
        del runs, node
        for v in variants:
            memory[f"{args.tag} {path} {names[v]}"] = path_memory(
                cs, dev, flat, n, v)
    cap, over = overflow_times(cs, dev, cs.DOUBLE_LASER, cs.SCANS_PER_ROBOT)
    for what in ("over", "fit"):
        lists[f"{args.tag} ICP overflow (MAX_SEGMENTS {cap}) process_scan, "
              f"scans that {'overflow' if what == 'over' else 'fit'}"] = \
            over[what]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": label, "times_ms": lists,
                       "memory_MiB": memory}, f)
    for name, ms in lists.items():
        report(name, ms, label)
    for name, mib in memory.items():
        print(f"{name} device memory over the path (MiB above the process "
              f"before it): {json.dumps(mib)} [{label}]")
    print(f"torch_step_times {args.tag}: {time.perf_counter() - t0:.1f} s "
          f"[{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
