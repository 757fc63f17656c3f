"""Multi-process runtime wiring (port of
ohm_tsd_slam_tpu/parallel/distributed.py).

The reference is one process (boost threads and OpenMP).  The JAX package
scales across hosts with jax.distributed; here each process is one rank
of a torch.distributed world, started by `torchrun` (or anything that
sets its variables), and the mesh (parallel/mesh.py) spans the world.
This module is the thin, testable part: initialisation from the
environment, each rank's device, and rank 0's scan handed to every rank.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ohm_tsd_slam_tpu_torch.utils.device import default_device


def local_device(device_type: Optional[str] = None) -> torch.device:
    """This process's device.  `device_type` None or "cuda" is the card,
    cuda:(LOCAL_RANK % device_count) (ranks beyond the cards share them),
    and raises where there is none; the CPU only when the caller names
    "cpu"."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type not in (None, "cuda"):
        raise ValueError(f"local_device: device_type must be \"cuda\" or "
                         f"\"cpu\", got {device_type!r}")
    default_device(device_type, "the mesh", "device_type")
    rank = int(os.environ.get("LOCAL_RANK", "0") or 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: Optional[str] = None) -> bool:
    """Join the torch.distributed world (init_process_group).

    Arguments default to torchrun's environment: WORLD_SIZE, RANK, and
    MASTER_ADDR / MASTER_PORT through init_method "env://".  Returns False
    and does nothing when neither the arguments nor the environment ask
    for a run of processes (no init_method and no MASTER_ADDR, or no world
    size), so one process never pays for a rendezvous.  Unlike the JAX
    package's, a world of one process counts as asked for: torchrun sets
    WORLD_SIZE=1 for one process, which then forms a mesh of one rank.

    The rank's device is local_device(device_type): the card unless
    "cpu" is named (without a card that raises).  The backend is "nccl"
    on a card and "gloo" on the CPU, unless named: several ranks sharing
    one card need "gloo" (NCCL refuses two ranks on one device).  On a
    card the rank's device is made current before the group forms.
    """
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "0") or 0)
    if (init_method is None and "MASTER_ADDR" not in env) or world_size < 1:
        return False
    if rank is None:
        rank = int(env.get("RANK", "0") or 0)
    device = local_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world_size,
        rank=rank)
    return True


def broadcast_scan(mesh, arrays: Sequence[np.ndarray],
                   device) -> list:
    """Rank 0's numpy scan arrays on every rank of the mesh, as tensors
    on `device` (one broadcast each).  Every rank passes arrays of the
    same shape and dtype; only rank 0's values count.  Bool arrays travel
    as uint8 (gloo has no bool)."""
    src = int(mesh.mesh.reshape(-1)[0])
    out = []
    for a in arrays:
        t = torch.as_tensor(np.ascontiguousarray(a)).to(device)
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        dist.broadcast(wire, src=src)
        out.append(wire.to(torch.bool) if t.dtype == torch.bool else wire)
    return out
