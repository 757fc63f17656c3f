"""Run one cell of the benchmark once.

    python slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json.  The program under
test is ohm_tsd_slam_tpu_torch on one CUDA card; a run that finds no card
(or fewer than the cell asks for) exits with code 2 and prints no result.
With --trace 0 the result's metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read after the same window from
probes and profiler sessions.  The last line of standard output is the
result, a JSON object; the numbers the check compared, each beside its
limit, are also the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules that must not be loaded: JAX and the JAX package this port
# replaces (compared by whole top-level name: the port's name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ohm_tsd_slam_tpu")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernels into ohm_tsd_slam_tpu_torch/_build/."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_label() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)

    from slambench import harness

    cell = harness.load_cell(args.workload, ROOT)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: cell {cell.name} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    from slambench import check

    readers = ({m["name"]: harness.reader(m["name"], ROOT)
                for m in cell.per_layer} if args.trace else {})
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    run.setup()
    run.run_window()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    w = run.window
    late_ms = sorted(x * 1e3 for x in w.late) or [0.0]
    worst = sorted(range(len(w.latency)), key=lambda i: -w.latency[i])[:8]
    print(json.dumps({
        "card": card_label(), "cell": cell.name, "seed": args.seed,
        "scans": w.attempted, "publishes": len(w.publish),
        "mapped": w.mapped, "overflowed": w.overflowed,
        "tracking_error_m": run.tracking_error_m(),
        "setup_phases_s": run.setup_phases,
        "circuits": run.stream.circuits,
        "generator_late_ms": {"p50": late_ms[len(late_ms) // 2],
                              "p95": late_ms[int(len(late_ms) * 0.95)],
                              "max": late_ms[-1]},
        "slowest_scans": [[i, w.latency[i] * 1e3] for i in worst]}),
          file=sys.stderr,
          flush=True)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        from slambench import tracing

        run.run_traced(readers)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = sum(tracing.busy_ns(s)
                               for s in run.sessions) * 1e-9
        device["window_s"] = sum(tracing.span_ns(s)
                                 for s in run.sessions) * 1e-9
        breakdown = tracing.breakdown(run.sessions)
    else:
        values = run.end_to_end()
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    run.free_program()
    values = check.readings(run.evidence, run.device)
    correct = check.verdict(values, cell.limits)
    checks = check.report(values, cell.limits)

    found = forbidden_modules()
    if found:
        print(f"slambench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
