"""The device mesh of the row-sharded SLAM step (port of
ohm_tsd_slam_tpu/parallel/mesh.py).

Two axes, as in the JAX package:

  * "sp" (spatial): the TSD grid's rows, in blocks of whole tile rows, one
    block a rank (the reference's OpenMP over partitions,
    TsdGrid.cpp:228-232);
  * "dp" (data): the robots (multi-SLAM, SlamNode.cpp:101-122).

A JAX Mesh becomes a torch.distributed.device_mesh.DeviceMesh over the
initialised world (parallel/distributed.py), its ranks laid out as JAX
lays out its devices: rank r at sp r // dp, dp r % dp.  Where the JAX
package places global arrays with NamedShardings and XLA inserts the
collectives, here each rank holds its own slice (`grid_sharding`,
`robot_sharding`) and the sharded paths make their collectives through
this module.

Every collective of those paths is an all_reduce over one mesh axis.  The
gloo backend takes CUDA tensors in all_reduce and broadcast only (not in
point-to-point operations or all_gather), so a gather or a neighbour
exchange is an all_reduce of a buffer of -0.0 in which each rank fills its
own slot: a slot has one writer and x + -0.0 == x for every x, so the sum
is exact, NaN, inf and a signed zero included (a buffer of +0.0 would turn
a -0.0 into +0.0).  The same code then runs on NCCL (one rank a card)
and on gloo (ranks sharing a card, or the CPU), whichever backend the
world was initialised with; nothing here depends on which.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.utils.device import default_device

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b == n."""
    best = (1, n)
    for a in range(1, math.isqrt(n) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(device_type: str = None,
              axes: Tuple[str, str] = ("sp", "dp")) -> DeviceMesh:
    """The 2D mesh over every rank of the initialised world, the
    most-square (sp, dp) = _factor2(world size).  `device_type` None is
    "cuda", which raises where there is no card: the mesh runs on the CPU
    only for a caller who names "cpu".  Another shape: build a DeviceMesh
    directly, as the JAX package's tests build a Mesh."""
    device_type = default_device(device_type, "make_mesh",
                                 "device_type").type
    return init_device_mesh(device_type, _factor2(dist.get_world_size()),
                            mesh_dim_names=axes)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def shard_rows(mesh: DeviceMesh, grid: TsdGrid,
               axis: str = "sp") -> Tuple[int, int, int]:
    """(first world row, rows, world rows) of this rank's row block
    `grid`, as grid_sharding cut it."""
    h = grid.cells_y
    return axis_index(mesh, axis) * h, h, h * axis_size(mesh, axis)


def grid_sharding(mesh: DeviceMesh, grid: TsdGrid) -> TsdGrid:
    """This rank's row block of the whole `grid`: rows [y0, y0 + H/sp) of
    tsd and weight and the matching tile rows of tile_init and tile_initw
    (copies: the rank holds its block only).  Raises unless H/sp is a
    multiple of the tile size."""
    sp = axis_size(mesh, "sp")
    H, td = grid.cells_y, grid.tile_dim
    if H % (sp * td):
        raise ValueError(f"grid_sharding: {H} rows do not split into {sp} "
                         f"blocks of whole {td}-cell tiles")
    i = axis_index(mesh, "sp")
    h = H // sp
    return dataclasses.replace(
        grid, tsd=grid.tsd[i * h:(i + 1) * h].clone(),
        weight=grid.weight[i * h:(i + 1) * h].clone(),
        tile_init=tile_sharding(mesh, grid.tile_init),
        tile_initw=tile_sharding(mesh, grid.tile_initw))


def tile_sharding(mesh: DeviceMesh, tiles: torch.Tensor) -> torch.Tensor:
    """This rank's tile rows of a whole [TY, TX] per-tile array (a copy):
    the rows grid_sharding takes of tile_init.  Raises unless the tile
    rows split evenly over "sp"."""
    sp = axis_size(mesh, "sp")
    if tiles.shape[0] % sp:
        raise ValueError(f"tile_sharding: {tiles.shape[0]} tile rows do "
                         f"not split over {sp} ranks")
    i, th = axis_index(mesh, "sp"), tiles.shape[0] // sp
    return tiles[i * th:(i + 1) * th].clone()


def robot_sharding(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice along "dp" of the robot axis (dim 0) of `x`.
    Raises unless the robots split evenly."""
    dp = axis_size(mesh, "dp")
    R = x.shape[0]
    if R % dp:
        raise ValueError(f"robot_sharding: {R} robots do not split over "
                         f"{dp} ranks")
    j, k = axis_index(mesh, "dp"), R // dp
    return x[j * k:(j + 1) * k]


def replicated(mesh: DeviceMesh, x):
    """`x` whole on every rank."""
    return x


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """`t` reduced ("sum" or "min") over the ranks of this rank's group
    along `axis`, in place; returns it."""
    dist.all_reduce(t, op=_OPS[op], group=mesh.get_group(axis))
    return t


def all_gather(t: torch.Tensor, mesh: DeviceMesh,
               axis: str) -> torch.Tensor:
    """[n, *t.shape]: every rank's `t` along `axis`, in the axis' order
    (floating `t`; `slots`, each rank its own, summed)."""
    buf = slots(t, axis_size(mesh, axis))
    buf[axis_index(mesh, axis)] = t
    return all_reduce(buf, mesh, axis)


def slots(t: torch.Tensor, n: int) -> torch.Tensor:
    """[n, *t.shape] of -0.0 in `t`'s dtype and device: a buffer whose
    slots, each filled by one rank, an all_reduce sums exactly (above)."""
    return t.new_full((n, *t.shape), -0.0)


class CollectiveCount:
    """While active, counts the all_reduce calls (every collective of the
    sharded paths) and their bytes and, with `timed`, the ms each takes on
    the host clock between two synchronisations of the card (which slow
    the run they measure).  It wraps torch.distributed.all_reduce for
    that time: instrumentation for tests and measurements."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.calls, self.bytes, self.ms = 0, 0, 0.0

    def __enter__(self):
        self._orig = dist.all_reduce

        def counted(t, *args, **kwargs):
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
            if not self.timed:
                return self._orig(t, *args, **kwargs)
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
            out = self._orig(t, *args, **kwargs)
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.ms += (time.perf_counter() - t0) * 1e3
            return out

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig


class _PSum(torch.autograd.Function):
    """Sum over a group whose backward hands the gradient on unchanged,
    as JAX's shard_map transposes psum.  (torch.distributed.nn's
    all_reduce sums the gradient over the group as well: a loss that every
    rank holds then gives each rank n times its own part.)  Each rank's
    gradient is then its own part of the whole; the caller sums those."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def psum(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Differentiable sum over `axis` (see _PSum): each rank's gradient is
    its part of the whole, to be summed over `axis` by the caller."""
    return _PSum.apply(t, mesh, axis)


def float_pack(parts: Sequence[torch.Tensor], dtype,
               lead: int = 0) -> torch.Tensor:
    """The parts in one `dtype` tensor, for one collective: each flattened
    after its first `lead` dims (which the parts share) and joined along
    the last."""
    return torch.cat([p.reshape(*p.shape[:lead], -1).to(dtype)
                      for p in parts], dim=-1)


def float_unpack(flat: torch.Tensor, like: Sequence[torch.Tensor],
                 lead: int = 0) -> list:
    """float_pack's inverse: each part back in its dtype and in its shape
    after the first `lead` dims, which take `flat`'s."""
    out, i = [], 0
    for p in like:
        n = math.prod(p.shape[lead:])
        out.append(flat[..., i:i + n].reshape(
            (*flat.shape[:-1], *p.shape[lead:])).to(p.dtype))
        i += n
    return out
