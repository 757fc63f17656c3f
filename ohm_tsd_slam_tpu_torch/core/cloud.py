"""Point-cloud containers (port of ohm_tsd_slam_tpu/core/cloud.py, the
obcore/base layer's point containers, unused by the 2D SLAM path):

* ``CartesianCloud`` ~ CartesianCloud3D
  (src/obcore/base/CartesianCloud.{h,cpp}): coords and optional normals,
  colours and host-side attributes; masking, transform, sub-sampling,
  pinhole projection and z-buffer.
* ``PointCloud`` ~ PointCloud<T> (src/obcore/base/PointCloud.h:33-76): an
  optionally organized (width x height) cloud with an intrinsic rotation.

Immutable dataclasses over dense ``[N, d]`` tensors with a validity mask
instead of erase-compaction: ``mask_points`` and ``remove_invalid_points``
flip mask bits rather than shrink the tensors, so shapes stay fixed and
nothing is read back.  The reference's variable-size source-info map
(CartesianCloud.h:104-130) is a plain dict on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class CartesianCloud:
    """CartesianCloud3D.

    Attributes:
      coords:  [N, 3] point coordinates.
      mask:    [N] validity (the reference's maskPoints /
               removeInvalidPoints erase; here invalid points stay, masked).
      normals: [N, 3] or None (hasNormals, CartesianCloud.h:98).
      colors:  [N, 3] uint8 or None (hasColors, CartesianCloud.h:104).
      attrs:   host-side metadata (addSourceInfo / getSourceInfo,
               CartesianCloud.h:111-130).
    """

    coords: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    attrs: Dict[str, float] = field(default_factory=dict)

    @property
    def size(self) -> int:
        """Allocated size (the reference's size() tracks erases; use
        valid_count() for the count after masking)."""
        return self.coords.shape[0]

    def valid_count(self) -> torch.Tensor:
        return self.mask.sum()

    def has_normals(self) -> bool:
        return self.normals is not None

    def has_colors(self) -> bool:
        return self.colors is not None


def create_cloud(coords, normals=None, colors=None,
                 attrs: Optional[Dict[str, float]] = None) -> CartesianCloud:
    """CartesianCloud3D(size, coords, rgb, normals) (CartesianCloud.cpp
    constructor): every point starts valid."""
    coords = torch.as_tensor(coords)
    return CartesianCloud(
        coords=coords,
        mask=torch.ones(coords.shape[0], dtype=torch.bool,
                        device=coords.device),
        normals=None if normals is None else torch.as_tensor(normals),
        colors=None if colors is None else torch.as_tensor(colors),
        attrs=dict(attrs or {}),
    )


def mask_points(cloud: CartesianCloud, keep: torch.Tensor) -> CartesianCloud:
    """maskPoints (CartesianCloud.h:132): intersect the validity."""
    return dataclasses.replace(cloud, mask=cloud.mask & keep)


def mask_empty_normals(cloud: CartesianCloud) -> CartesianCloud:
    """maskEmptyNormals (CartesianCloud.h:133): drop points whose normal
    is the zero vector."""
    if cloud.normals is None:
        return cloud
    return mask_points(cloud, (cloud.normals != 0.0).any(dim=1))


def remove_invalid_points(cloud: CartesianCloud) -> CartesianCloud:
    """removeInvalidPoints (CartesianCloud.h:138): drop points with a
    non-finite coordinate (the erase becomes a mask update)."""
    return mask_points(cloud, torch.isfinite(cloud.coords).all(dim=1))


def subsample(cloud: CartesianCloud, step: int) -> CartesianCloud:
    """subsample(step) (CartesianCloud.h:144): keep every step-th point."""
    keep = torch.arange(cloud.size, device=cloud.coords.device) % step == 0
    return mask_points(cloud, keep)


def transform(cloud: CartesianCloud, T: torch.Tensor) -> CartesianCloud:
    """transform(Matrix* T) (CartesianCloud.h:156): a 4x4 homogeneous
    transform of the coords; normals rotate only."""
    R = T[:3, :3]
    t = T[:3, 3]
    coords = cloud.coords @ R.T + t
    normals = None if cloud.normals is None else cloud.normals @ R.T
    return dataclasses.replace(cloud, coords=coords, normals=normals)


def project_to_image(cloud: CartesianCloud, P: torch.Tensor,
                     width: int, height: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """createProjection / createZBuffer (CartesianCloud.h:167-177): project
    through the 3x4 pinhole matrix P; the nearest z wins each pixel (the
    reference's sequential insert-and-compare becomes a min-scatter).

    Returns:
      zbuffer: [height, width] nearest depth per pixel (inf = empty).
      hit:     [height, width] bool occupancy.
    """
    x, y, z = cloud.coords[:, 0], cloud.coords[:, 1], cloud.coords[:, 2]
    w = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + P[2, 3]
    ok = cloud.mask & (w.abs() > 1e-12) & (z > 0.0)
    u = (P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]) / w
    v = (P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]) / w
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    ok = ok & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    # a point that misses the image scatters into a spare slot past the end
    flat = torch.where(ok, vi.long() * width + ui.long(), height * width)
    depth = torch.where(ok, z, torch.inf)
    zbuf = torch.full((height * width + 1,), torch.inf,
                      dtype=cloud.coords.dtype, device=cloud.coords.device)
    zbuf = zbuf.scatter_reduce(0, flat, depth, reduce="amin")
    zbuf = zbuf[:-1].reshape(height, width)
    return zbuf, torch.isfinite(zbuf)


# ---------------------------------------------------------------------------
# PointCloud<T>: organized cloud (PointCloud.h:33-76)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PointCloud:
    """Organized point cloud: points [H*W, d] with its width and height.

    ``is_organized`` mirrors PointCloud.h:54 (height != 1).
    """

    points: torch.Tensor
    width: int
    height: int

    @property
    def size(self) -> int:
        return self.points.shape[0]

    @property
    def is_organized(self) -> bool:
        return self.height != 1


def create_point_cloud(points, width: Optional[int] = None,
                       height: int = 1) -> PointCloud:
    points = torch.as_tensor(points)
    if width is None:
        width = points.shape[0]
    if width * height != points.shape[0]:
        raise ValueError(f"{width} x {height} does not hold "
                         f"{points.shape[0]} points")
    return PointCloud(points=points, width=width, height=height)


def rotate_rpy(cloud: PointCloud, roll, pitch, yaw) -> PointCloud:
    """PointCloud::rotate(roll, pitch, yaw) (PointCloud.h:68): the
    intrinsic XYZ rotation of every point."""
    dtype, dev = cloud.points.dtype, cloud.points.device

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    cr, sr = torch.cos(t(roll)), torch.sin(t(roll))
    cp, sp = torch.cos(t(pitch)), torch.sin(t(pitch))
    cy, sy = torch.cos(t(yaw)), torch.sin(t(yaw))
    one, zero = t(1.0), t(0.0)
    Rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cr, -sr]),
                      torch.stack([zero, sr, cr])])
    Ry = torch.stack([torch.stack([cp, zero, sp]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sp, zero, cp])])
    Rz = torch.stack([torch.stack([cy, -sy, zero]),
                      torch.stack([sy, cy, zero]),
                      torch.stack([zero, zero, one])])
    R = Rz @ Ry @ Rx
    return dataclasses.replace(cloud, points=cloud.points @ R.T)


# ---------------------------------------------------------------------------
# CartesianCloudFactory codecs (src/obcore/base/CartesianCloudFactory.cpp)
# ---------------------------------------------------------------------------

def save_cloud_ascii(path: str, cloud: CartesianCloud) -> None:
    """CartesianCloudFactory::serialize(eFormatAscii)
    (CartesianCloudFactory.cpp:36-52): one "x y z [r g b]" line a point;
    colours only when present.  (The reference writes the FIRST point's
    colour on every row; each point's own colour is written here, as the
    JAX package does.)"""
    coords = cloud.coords.detach().cpu().numpy().astype(np.float64)
    colors = (cloud.colors.cpu().numpy() if cloud.colors is not None
              else None)
    with open(path, "w") as f:
        for i in range(coords.shape[0]):
            f.write(f"{coords[i, 0]:g} {coords[i, 1]:g} "
                    f"{coords[i, 2]:g}")
            if colors is not None:
                f.write(f" {int(colors[i, 0])} {int(colors[i, 1])}"
                        f" {int(colors[i, 2])}")
            f.write("\n")


def load_cloud_ascii(path: str, dtype=torch.float32) -> CartesianCloud:
    """CartesianCloudFactory::load(eFormatAscii)
    (CartesianCloudFactory.cpp:55-92): "x y z r g b" rows; a point is
    valid (ePointAttrValid) iff z > 0."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                rows.append([float(v) for v in parts[:6]])
    arr = (np.asarray(rows, np.float64) if rows
           else np.zeros((0, 6), np.float64))
    return CartesianCloud(
        coords=torch.as_tensor(arr[:, :3], dtype=dtype),
        mask=torch.from_numpy(arr[:, 2] > 0.0),
        colors=torch.from_numpy(arr[:, 3:6].astype(np.uint8)))
