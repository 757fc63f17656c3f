"""The 25-scan golden loop replayed through the port's SlamNode (float64,
CPU) at its defaults (the isocontour caster, grid/raycast_fast.py), held
against the compiled C++ reference (golden/data/slam.bin) and against the
JAX SlamNode at its defaults."""

import pytest

from ohm_tsd_slam_tpu_torch.slam import LaserScan
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

from test_torch_slam import (
    _assert_matches_jax_node,
    _assert_matches_reference,
    _cpu_node,
    _golden_config,
    _replay,
    tcfg,
)

limit_cpu_threads()


@pytest.fixture(scope="module")
def port_replay_fast():
    """The port's replay at its defaults: the isocontour caster."""
    node = _cpu_node(_golden_config(tcfg))
    out = _replay(node, LaserScan)
    assert node.localizers[0].params.fast_raycast
    assert node.localizers[0].rays_dropped == 0
    return out


def test_golden_replay_fast_matches_reference(port_replay_fast):
    _assert_matches_reference(port_replay_fast)


def test_golden_replay_fast_matches_jax_node(port_replay_fast):
    """Both nodes at their defaults: the fast caster on both sides."""
    _assert_matches_jax_node(port_replay_fast, fast=True)
