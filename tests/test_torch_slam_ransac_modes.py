"""The node in the RANSAC pre-registration modes TSD, EXP and PDF on a
small room, float64 on the CPU: tracking, and a trace that is a function
of the node's seed."""

import pytest
import torch

from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

from test_torch_slam import _cpu_node, _ransac_cfg, _room_trace

limit_cpu_threads()


@pytest.mark.parametrize("mode", [3, 1, 2])
def test_node_tracks_in_ransac_modes(mode):
    """TSD, EXP and PDF through SlamNode on the CPU: the pose tracks the
    simulated truth within 2.5 cells (tests/test_slam_e2e.py's bound), the
    trace is a function of the node's seed, and another seed draws other
    trials."""
    cfg = _ransac_cfg(mode)
    node = _cpu_node(cfg, seed=5)
    trace, err = _room_trace(node)
    loc = node.localizers[0]
    assert loc.params.mode == mode and loc.params.ransac.trials == 20
    assert loc.scan_count == 7 and loc.rays_dropped == 0
    assert err < 2.5 * cfg.grid.cellsize, err
    again, _ = _room_trace(_cpu_node(cfg, seed=5))
    assert torch.equal(trace, again)
    other, err_other = _room_trace(_cpu_node(cfg, seed=6))
    assert not torch.equal(trace, other)
    assert err_other < 2.5 * cfg.grid.cellsize, err_other
