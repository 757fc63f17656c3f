"""Multi-hypothesis ICP restarts (port of
ohm_tsd_slam_tpu/registration/multi_init.py).

IcpMultiInitIterator (src/obvision/registration/icp/
IcpMultiInitIterator.cpp): run ICP from a list of initial transforms plus
the previous call's winner and keep the result with the most pairs
(assignBetterSolution, :26-38).  The JAX package vmaps ICP over the seeds;
here the seeds run one after another (each a fixed-shape ICP with no host
read), and the winner is picked on the device.  The "last transformation"
memory is functional: the caller threads `T_last` through the calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp
from ohm_tsd_slam_tpu_torch.registration.ransac import _at


class MultiInitResult(NamedTuple):
    T: torch.Tensor           # (3,3) best final transform
    rms: torch.Tensor
    pairs: torch.Tensor
    iterations: torch.Tensor
    best_seed: torch.Tensor   # index into the seed batch
    T_last: torch.Tensor      # carry for the next call (== T)


def icp_multi_init(model: torch.Tensor, model_mask: torch.Tensor,
                   scene: torch.Tensor, scene_mask: torch.Tensor,
                   seeds: torch.Tensor, params: IcpParams,
                   T_last: Optional[torch.Tensor] = None,
                   sensor_pose: Optional[torch.Tensor] = None
                   ) -> MultiInitResult:
    """Run ICP from every seed in `seeds` [K, 3, 3] (and from T_last as one
    more seed, appended last, IcpMultiInitIterator.cpp:64-71) and return
    the result with the most pairs, the first such seed on a tie."""
    if T_last is not None:
        seeds = torch.cat([seeds, T_last[None].to(seeds.dtype)], dim=0)
    runs = [icp(model, model_mask, scene, scene_mask, params, T_init=T0,
                sensor_pose=sensor_pose) for T0 in seeds.unbind(0)]
    pairs = torch.stack([r.pairs for r in runs])
    best = pairs.argmax()
    T = _at(torch.stack([r.T for r in runs]), best)
    return MultiInitResult(
        T=T, rms=_at(torch.stack([r.rms for r in runs]), best),
        pairs=_at(pairs, best),
        iterations=_at(torch.stack([r.iterations for r in runs]), best),
        best_seed=best, T_last=T)
