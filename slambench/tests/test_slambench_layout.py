"""The harness is driven by data: a configuration, a traffic mix, a
metric and a cell's limits dropped in as new files form a cell that the
harness lists, loads and runs, with no existing file edited.  A run that
finds no card fails and prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from slambench import harness
from slambench.tests import tiny

NEW_METRIC = '''
def read(run):
    return float(run.window.attempted)
'''


def _tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "slambench"),
                    root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return root


def test_new_files_form_a_cell(tmp_path):
    root = _tree(tmp_path)
    before = {p: open(p, "rb").read()
              for p in map(str, root.rglob("*")) if os.path.isfile(p)}
    sb = root / "slambench"
    cfg = json.loads((sb / "configs" / "single-laser.json").read_text())
    cfg["icp_iterations"] = 20
    (sb / "configs" / "slow-walker.json").write_text(json.dumps(cfg))
    mix = json.loads((sb / "traffic" / "live-walk.json").read_text())
    mix["step_m"] = 0.01
    (sb / "traffic" / "live-stroll.json").write_text(json.dumps(mix))
    (sb / "metrics" / "window_scans.py").write_text(NEW_METRIC)
    (sb / "limits" / "slow-walker.live-stroll.json").write_text(
        (sb / "limits" / "single-laser.live-walk.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="slow-walker",
                                 file="slambench/configs/slow-walker.json"))
    bench["workloads"].append({"name": "slow-walker.live-stroll",
                               "config": "slow-walker",
                               "traffic": "live-stroll", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "window_scans", "unit": "scans",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "node", "moves": "setup_s",
                               "workloads": ["slow-walker.live-stroll"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        if not path.endswith("BENCHMARK.json"):
            assert open(path, "rb").read() == data, path

    assert "slow-walker.live-stroll" in harness.list_cells(str(root))
    c = harness.load_cell("slow-walker.live-stroll", str(root))
    assert c.params["icp_iterations"] == 20
    assert c.traffic["step_m"] == 0.01
    assert [m["name"] for m in c.per_layer][-1] == "window_scans"
    assert "window_scans" not in [
        m["name"] for m in harness.load_cell("single-laser.live-walk",
                                             str(root)).per_layer]
    small = tiny.cell("slow-walker.live-stroll", str(root))
    run = tiny.run(small, seed=7, seconds=0.3)
    assert harness.reader("window_scans", str(root)).read(run) == 12.0
    steps = run.stream.truth[0][1:, :2] - run.stream.truth[0][:-1, :2]
    assert abs(float((steps ** 2).sum(1).max()) ** 0.5 - 0.01) < 1e-9


def test_a_run_without_a_card_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "double-laser.live-walk", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and slambench/ has no program
    to run: the run fails and prints no result (here at the card check,
    on the card at the program's import)."""
    root = _tree(tmp_path)
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "double-laser.live-walk", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    """On the card: one short run of each cell prints one result line
    with its metrics and `correct` true."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in harness.list_cells():
        out = subprocess.run(
            [sys.executable, "slambench/run.py", "--workload", name,
             "--seed", "2200000001", "--seconds", "2", "--trace", "0"],
            cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True
        assert result["device"]["platform"] == "gpu"
        assert set(result["metrics"]) >= {"setup_s",
                                          "scan_latency_p50_ms"}


def test_benchmark_json_is_well_formed():
    """Every piece BENCHMARK.json names exists, and every per-layer metric
    moves an end-to-end metric that each of its cells reports."""
    import re

    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    cells = {w["name"]: w for w in bench["workloads"]}
    for c in bench["configs"]:
        assert name.match(c["name"])
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in cells.values():
        assert name.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        harness.load_cell(w["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in bench["per_layer"]:
        assert name.match(m["name"]) and m["name"] not in e2e
        assert hasattr(harness.reader(m["name"]), "read")
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
