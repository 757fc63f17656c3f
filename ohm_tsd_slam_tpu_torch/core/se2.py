"""SE(2) rigid-transform utilities (port of ohm_tsd_slam_tpu/core/se2.py).

Poses are plain (3, 3) homogeneous tensors; every function is a pure
function of its inputs and keeps their dtype and device.  Point
transforms are written elementwise, as in the JAX package, so that no
small matmul changes the rounding of world coordinates.
"""

from __future__ import annotations

import torch


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device)


def make(x, y, theta, dtype=torch.float32, device=None) -> torch.Tensor:
    """Build an SE(2) transform [[R(theta), t], [0, 1]]
    (src/ThreadLocalize.cpp:296-308).  A Python number becomes a tensor by
    a fill on `device`, never by a copy from the host (which waits for
    the card)."""
    x, y, theta = (torch.full((), v, dtype=dtype, device=device)
                   if isinstance(v, (int, float))
                   else torch.as_tensor(v, dtype=dtype, device=device)
                   for v in (x, y, theta))
    c, s = torch.cos(theta), torch.sin(theta)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, x]),
                        torch.stack([s, c, y]),
                        torch.stack([zero, zero, one])])


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[:2, :2]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[:2, 2]


def angle(T: torch.Tensor) -> torch.Tensor:
    """Rotation angle: atan2 over the first column
    (src/ThreadLocalize.cpp:715-726 in closed form)."""
    return torch.atan2(T[1, 0], T[0, 0])


def invert(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(2) inverse: [Rᵀ, -Rᵀ t] (elementwise)."""
    tix = -(T[0, 0] * T[0, 2] + T[1, 0] * T[1, 2])
    tiy = -(T[0, 1] * T[0, 2] + T[1, 1] * T[1, 2])
    zero = torch.zeros_like(tix)
    one = torch.ones_like(tix)
    return torch.stack([torch.stack([T[0, 0], T[1, 0], tix]),
                        torch.stack([T[0, 1], T[1, 1], tiy]),
                        torch.stack([zero, zero, one])])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply T to an (..., 2) point array (rotate + translate)."""
    x = pts[..., 0]
    y = pts[..., 1]
    out_x = T[0, 0] * x + T[0, 1] * y + T[0, 2]
    out_y = T[1, 0] * x + T[1, 1] * y + T[1, 2]
    return torch.stack([out_x, out_y], dim=-1)


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of T to an (..., 2) vector array."""
    x = vecs[..., 0]
    y = vecs[..., 1]
    out_x = T[0, 0] * x + T[0, 1] * y
    out_y = T[1, 0] * x + T[1, 1] * y
    return torch.stack([out_x, out_y], dim=-1)


def embed44(T3: torch.Tensor) -> torch.Tensor:
    """Embed a 3x3 SE(2) transform into a 4x4 (the reference keeps ICP
    state as 4x4; src/obvision/registration/icp/Icp.cpp:528-546)."""
    T4 = torch.eye(4, dtype=T3.dtype, device=T3.device)
    T4[:2, :2] = T3[:2, :2]
    T4[:2, 3] = T3[:2, 2]
    return T4


def extract33(T4: torch.Tensor) -> torch.Tensor:
    """The 3x3 SE(2) transform of embed44's 4x4."""
    T3 = torch.eye(3, dtype=T4.dtype, device=T4.device)
    T3[:2, :2] = T4[:2, :2]
    T3[:2, 2] = T4[:2, 3]
    return T3
