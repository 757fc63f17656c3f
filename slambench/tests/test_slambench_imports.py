"""No module under slambench/ imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from slambench import harness

BENCH = os.path.join(harness.ROOT, "slambench")
FORBIDDEN = {"jax", "jaxlib", "flax", "ohm_tsd_slam_tpu"}


def _modules():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for path in _modules():
        if path.startswith(ref):
            assert "ohm_tsd_slam_tpu_torch" not in set(_imports(path)), path
    code = ("import sys, slambench.reference.slam, slambench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ohm_tsd_slam_tpu_torch', 'ohm_tsd_slam_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """What the harness's run imports, by module name, on the CPU."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from slambench import harness, check, tracing, rooflines; "
            "from slambench.tests import tiny; "
            "r = tiny.run(tiny.cell('double-laser.live-walk'), 5, 0.2); "
            "check.readings(r.evidence, r.device); "
            "sys.path.insert(0, 'slambench'); import run; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
