"""Polar 2D laser sensor model (port of ohm_tsd_slam_tpu/sensor/polar2d.py).

The geometry is a frozen dataclass of static scan parameters and every
operation is a pure function of (geometry, pose, ranges) that vectorizes
over beams (reference: SensorPolar2D.cpp, Sensor.cpp).

Semantics replicated exactly:
  * beam directions phi_i = phi_min + i * res  (SensorPolar2D.cpp:39-44)
  * angular bounds  (SensorPolar2D.cpp:26-30)
  * batch backProject with -1/-2 out-of-bounds codes
    (SensorPolar2D.cpp:117-135)
  * standard masking: zero depth, invalid depth, 3-degree depth
    discontinuity  (SensorPolar2D.cpp:59-98, Sensor.cpp:252-272)
  * polar->Cartesian scan conversion  (Sensor.cpp:168-190)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ohm_tsd_slam_tpu_torch.core import se2

# backProject out-of-bounds codes (SensorPolar2D.cpp:131-133)
IDX_BELOW_FOV = -2   # angle below lower bound
IDX_ABOVE_FOV = -1   # angle above upper bound


@dataclass(frozen=True)
class SensorPolar2D:
    """Static polar-scan geometry (immutable, hashable)."""

    size: int
    angular_res: float
    phi_min: float
    max_range: float
    min_range: float = 0.001
    low_reflectivity_range: float = 2.0

    @property
    def phi_lower_bound(self) -> float:
        # smallest in-bounds angle (SensorPolar2D.cpp:26)
        return -0.5 * self.angular_res + self.phi_min

    @property
    def phi_upper_bound(self) -> float:
        # upper bound phi_min + (size-0.5)*res (SensorPolar2D.cpp:30)
        return self.phi_min + (self.size - 0.5) * self.angular_res

    def angles(self, dtype=torch.float32, device=None) -> torch.Tensor:
        i = torch.arange(self.size, dtype=dtype, device=device)
        return self.phi_min + i * self.angular_res

    def rays_local(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Unit beam directions in the sensor frame, shape (size, 2)."""
        phi = self.angles(dtype, device)
        return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def back_project(geom: SensorPolar2D, pose: torch.Tensor,
                 points: torch.Tensor) -> torch.Tensor:
    """Map world points (..., 2) to int32 beam indices, or IDX_BELOW_FOV /
    IDX_ABOVE_FOV (SensorPolar2D::backProject, SensorPolar2D.cpp:117-135).

    The bin is C round() = floor(x + 0.5): the argument is > -0.5 by
    construction, so half-away-from-zero and floor(x + 0.5) agree.  The
    resolution divides as a tensor: on CUDA, torch turns a division by a
    Python number into a product with its reciprocal, which is not the
    IEEE quotient that the CPU and the push kernel (csrc/push.cu) take.
    """
    local = se2.transform_points(se2.invert(pose), points)
    phi = torch.atan2(local[..., 1], local[..., 0])
    res = torch.full((), geom.angular_res, dtype=phi.dtype,
                     device=phi.device)
    idx = torch.floor((phi - geom.phi_min) / res + 0.5)
    idx = idx.to(torch.int32)
    below = torch.full_like(idx, IDX_BELOW_FOV)
    above = torch.full_like(idx, IDX_ABOVE_FOV)
    idx = torch.where(phi <= geom.phi_lower_bound, below, idx)
    idx = torch.where(phi >= geom.phi_upper_bound, above, idx)
    return idx


def mask_invalid_depth(geom: SensorPolar2D, data: torch.Tensor,
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sensor::maskInvalidDepth (Sensor.cpp:258-272): ranges beyond
    max_range become +inf; NaNs become +inf and are masked out."""
    data = torch.where(data > geom.max_range, math.inf, data)
    isnan = torch.isnan(data)
    mask = mask & ~isnan
    data = torch.where(isnan, math.inf, data)
    return data, mask


def mask_depth_discontinuity(geom: SensorPolar2D, data: torch.Tensor,
                             mask: torch.Tensor,
                             thresh: float) -> torch.Tensor:
    """Depth-discontinuity masking with radius 1 (SensorPolar2D.cpp:67-98):
    law of cosines for the neighbour distance c, law of sines for the
    angle beta when a > b; the beam is cut when min beta < thresh."""
    res = torch.full((), geom.angular_res, dtype=data.dtype,
                     device=data.device)
    cosphi = torch.cos(res)
    sinphi = torch.sin(res)

    a = data
    betamin = torch.full_like(data, math.pi)
    for shift in (-1, 1):
        b = torch.roll(data, -shift)
        # the first/last beams are excluded below (the reference loop
        # runs i in [1, size-2])
        c = torch.sqrt(a * a + b * b - 2.0 * a * b * cosphi)
        beta = torch.asin(torch.clamp(b / c * sinphi, -1.0, 1.0))
        consider = (a > b) & ~torch.isinf(b)
        betamin = torch.where(consider, torch.minimum(betamin, beta),
                              betamin)

    interior = torch.zeros_like(mask)
    interior[1:-1] = True
    cut = interior & ~torch.isinf(a) & (betamin < thresh)
    return mask & ~cut


def standard_mask(geom: SensorPolar2D, data: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SensorPolar2D::setStandardMask (SensorPolar2D.cpp:59-65): mask
    zero depth, invalid depth (mutating data), 3-degree discontinuities.
    Returns (possibly modified data, mask)."""
    mask = data != 0.0                          # maskZeroDepth (Sensor.cpp:252-256)
    data, mask = mask_invalid_depth(geom, data, mask)
    mask = mask_depth_discontinuity(geom, data, mask, math.radians(3.0))
    return data, mask


def data_to_cartesian(geom: SensorPolar2D, data: torch.Tensor,
                      mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sensor::dataToCartesianVectorMask (Sensor.cpp:168-190): beam-aligned
    scene points rays_local * range with a validity mask (finite & masked);
    invalid slots are zeroed."""
    rays = geom.rays_local(data.dtype, data.device)
    valid = mask & ~torch.isinf(data)
    coords = torch.where(valid[:, None], rays * data[:, None], 0.0)
    return coords, valid


def clamp_min_range(data: torch.Tensor,
                    laser_min_range: float) -> torch.Tensor:
    """Ranges below laser_min_range become 0 so the standard mask drops
    them (ThreadLocalize.cpp:252-256)."""
    if laser_min_range <= 0.0:
        return data
    return torch.where(data < laser_min_range, 0.0, data)
