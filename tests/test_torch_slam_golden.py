"""The 25-scan golden loop replayed through the port's SlamNode (float64,
CPU) with the exact march, held against the compiled C++ reference
(golden/data/slam.bin) and against the JAX SlamNode with the exact march."""

import pytest

from ohm_tsd_slam_tpu.slam import localize as jlocalize
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.slam import LaserScan
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

from test_torch_slam import (
    _assert_matches_jax_node,
    _assert_matches_reference,
    _cpu_node,
    _exact_march,
    _golden_config,
    _replay,
    tcfg,
)

limit_cpu_threads()


@pytest.fixture(scope="module")
def port_replay():
    """The port's replay with the exact march."""
    with pytest.MonkeyPatch.context() as mp:
        _exact_march(tlocalize.LocalizeParams, mp)
        node = _cpu_node(_golden_config(tcfg))
        assert node.mapper._push_fn is push     # CPU grid: the plain push
        out = _replay(node, LaserScan)
    assert not node.localizers[0].params.fast_raycast
    return out


def test_golden_replay_matches_reference(port_replay):
    _assert_matches_reference(port_replay)


def test_golden_replay_matches_jax_node(port_replay, monkeypatch):
    _exact_march(jlocalize.LocalizeParams, monkeypatch)
    _assert_matches_jax_node(port_replay, fast=False)
