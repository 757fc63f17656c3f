"""The port's multi-robot step over a mesh in mode AMCL: the checks of
tests/test_torch_sharded_step.py, its inputs and mesh shapes, with the
draws JAX makes from each robot's key injected into the port; a file of
its own to keep each test file's time short."""

import pytest

from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from test_torch_sharded_step import SHAPES, _ids, check_step, run_case

limit_cpu_threads()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_case(("amcl",), tmp_path_factory.mktemp("sharded_amcl"))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_step_matches_jax_and_one_card(case, shape):
    check_step(case, shape, "amcl")
