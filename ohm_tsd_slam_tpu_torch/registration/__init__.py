from ohm_tsd_slam_tpu_torch.registration.icp import (
    IcpParams,
    IcpResult,
    IcpState,
    icp,
)
from ohm_tsd_slam_tpu_torch.registration.estimators import (
    closed_form_2d,
    point_to_line_2d,
)
from ohm_tsd_slam_tpu_torch.registration.nn import (
    assign_pairs_fused,
    nearest_neighbors,
)
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    RansacParams,
    match_normal,
    match_pdf,
    match_tsd,
)

__all__ = [
    "IcpParams",
    "IcpResult",
    "IcpState",
    "icp",
    "closed_form_2d",
    "point_to_line_2d",
    "assign_pairs_fused",
    "nearest_neighbors",
    "RansacParams",
    "match_normal",
    "match_pdf",
    "match_tsd",
]
