"""Readings for the check's limits, on the card, at a cell's own size.

    python slambench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control tf32 bf16]

For each seed, in one process: the cell's set-up and a window of the
given length at the cell's own load, then the check's numbers for the
program (the lower readings) and for each control, the plain reference
computed in a lower precision put in the program's place (the upper
readings).  One JSON line a seed and reading.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", nargs="*", default=["tf32", "bf16"])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from slambench import check, harness

    if not torch.cuda.is_available():
        print("slambench control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        run = harness.Run(cell, seed, args.seconds, trace=False)
        run.setup()
        run.run_window()
        torch.cuda.synchronize()
        run.node = None
        for control in [None, *args.control]:
            t = time.perf_counter()
            values = check.readings(run.evidence, run.device, control)
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "reading": control or "program",
                              "scans": len(run.evidence.scans),
                              "publishes": len(run.evidence.publishes),
                              "check_s": time.perf_counter() - t,
                              **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
