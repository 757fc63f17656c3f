from ohm_tsd_slam_tpu_torch.registration.icp import (
    IcpParams,
    IcpResult,
    IcpState,
    icp,
    icp_jit,
)
from ohm_tsd_slam_tpu_torch.registration.amcl import AmclParams, match_amcl
from ohm_tsd_slam_tpu_torch.registration.estimators import (
    closed_form_2d,
    point_to_line_2d,
)
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
    GnParams,
    GnResult,
    match_gauss_newton,
    match_gauss_newton_jit,
)
from ohm_tsd_slam_tpu_torch.registration.multi_init import (
    MultiInitResult,
    icp_multi_init,
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
from ohm_tsd_slam_tpu_torch.registration.twinpoint import match_twinpoint

__all__ = [
    "AmclParams",
    "match_amcl",
    "IcpParams",
    "IcpResult",
    "IcpState",
    "icp",
    "icp_jit",
    "closed_form_2d",
    "point_to_line_2d",
    "GnParams",
    "GnResult",
    "match_gauss_newton",
    "match_gauss_newton_jit",
    "MultiInitResult",
    "icp_multi_init",
    "assign_pairs_fused",
    "nearest_neighbors",
    "RansacParams",
    "match_normal",
    "match_pdf",
    "match_tsd",
    "match_twinpoint",
]
