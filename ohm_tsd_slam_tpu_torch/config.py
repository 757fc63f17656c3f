"""Typed configuration tree for the SLAM framework.

A copy of ohm_tsd_slam_tpu/config.py: importing the JAX package would
import jax, which the PyTorch port must run without.

Mirrors the full ROS 2 parameter surface of the reference node
(node-level params: src/SlamNode.cpp:40-67; per-robot/registration params:
src/ThreadLocalize.cpp:86-129 and init() :424-442; grid-publisher params:
src/ThreadGrid.cpp:42-52) as plain dataclasses, loadable from the same YAML
profiles (config/*.yaml).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class RegMode(enum.IntEnum):
    """Registration mode enum (src/ThreadLocalize.h:75-81)."""

    ICP = 0  # plain ICP, no pre-registration
    EXP = 1  # RandomNormalMatching pre-registration + ICP
    PDF = 2  # PDFMatching pre-registration + ICP
    TSD = 3  # TSD_PDFMatching pre-registration + ICP
    # TPU-native extension (no reference analogue): direct scan-to-map
    # Gauss-Newton on the TSD field — no raycast, no NN search
    # (registration/gauss_newton.py).
    GN = 4
    # Working realization of the reference's declared-but-unimplemented
    # AdaptiveMonteCarloMatching stub (amcl/AdaptiveMonteCarloMatching.h:
    # 16-40): particle-filter pre-match + ICP refinement
    # (registration/amcl.py).
    AMCL = 5


@dataclass(frozen=True)
class GridConfig:
    """TSD grid geometry (src/SlamNode.cpp:40-78).

    The grid is square with 2**map_size cells per side, tiled into
    tile_dim x tile_dim tiles (reference LAYOUT_32x32 partitions,
    src/SlamNode.cpp:77).
    """

    map_size: int = 10                 # octave: cells/side = 2**map_size (<=15, SlamNode.cpp:71-75)
    cellsize: float = 0.025            # meters per cell
    truncation_radius: float = 3.0     # maxTruncation = truncation_radius * cellsize
    tile_dim: int = 32                 # cells per tile side (LAYOUT_32x32)
    max_weight: float = 32.0           # TSDGRIDMAXWEIGHT (reconstruct_defs.h:4)

    @property
    def cells_per_side(self) -> int:
        return 2 ** self.map_size

    @property
    def size_meters(self) -> float:
        return self.cells_per_side * self.cellsize

    @property
    def tiles_per_side(self) -> int:
        return self.cells_per_side // self.tile_dim

    @property
    def max_truncation(self) -> float:
        # Truncation radius must be >= 2 cells (TsdGrid.cpp:206-215).
        return max(self.truncation_radius * self.cellsize, 2.0 * self.cellsize)


@dataclass(frozen=True)
class SensorConfig:
    """Per-robot laser parameters (src/ThreadLocalize.cpp:424-442)."""

    max_range: float = 30.0
    min_range: float = 0.001
    low_reflectivity_range: float = 2.0
    laser_min_range: float = 0.0       # ranges below are zeroed (ThreadLocalize.cpp:252-256)
    # scan geometry (from the first LaserScan message in the reference)
    beams: int = 1081
    angle_min: float = -2.356194490192345   # -135 deg, Hokuyo UTM-30LX style
    angle_increment: float = math.radians(0.25)


@dataclass(frozen=True)
class IcpConfig:
    """ICP engine parameters (src/ThreadLocalize.cpp:209-225)."""

    iterations: int = 25               # ICP_ITERATIONS default (ThreadLocalize.h:58)
    max_rms: float = 0.0               # Icp maxRMS (ThreadLocalize.cpp:223)
    # rms-plateau counter; None = iterations, replicating
    # setConvergenceCounter(icpIterations) (ThreadLocalize.cpp:226)
    convergence_count: Optional[int] = None
    dist_filter_min: float = 0.2       # DistanceFilter mindist (ThreadLocalize.cpp:92-97)
    dist_filter_max: float = 1.0       # DistanceFilter maxdist
    # DistanceFilter's shrink-rate iteration count; None replicates the
    # reference's (unsigned)(icpIterations - 10) (ThreadLocalize.cpp:213)
    dist_iterations: Optional[int] = None
    use_distance_filter: bool = True
    use_reciprocal_filter: bool = True
    # rigid estimator strategy (Icp::setRigidEstimator, Icp.h:39-314):
    # "closed_form" = ClosedFormEstimator2D (the reference default,
    # ThreadLocalize.cpp:217), "point_to_line" = PointToLine2DEstimator
    # using raycast normals
    estimator: str = "closed_form"


@dataclass(frozen=True)
class RansacConfig:
    """RANSAC matcher parameters.

    The matcher constructors consume the node-level params `trials`,
    `sizeControlSet`, `epsThresh` (src/ThreadLocalize.cpp:105-107,
    184-190); only `ransac_phi_max` is per-robot and passed at match
    time (src/ThreadLocalize.cpp:172,538-558)."""

    trials: int = 100                  # "trials" (ThreadLocalize.cpp:105)
    eps_thresh: float = 0.15           # "epsThresh" (:107)
    size_control_set: int = 140        # "sizeControlSet" (:106)
    phi_max_deg: float = 30.0          # "<robot>ransac_phi_max" (:168)


@dataclass(frozen=True)
class BeamModelConfig:
    """Probabilistic-Robotics beam model for PDF matching
    (src/ThreadLocalize.cpp:118-129, ransacMatching/PDFMatching.cpp)."""

    zhit: float = 0.45
    zphi: float = 0.0
    zshort: float = 0.25
    zmax: float = 0.05
    zrand: float = 0.25
    sig_hit: float = 0.2               # "sighit" (ThreadLocalize.cpp:116)
    sig_phi: float = math.radians(3.0)  # "sigphi" (:115)
    lam_short: float = 0.08            # "lamshort" (:117)
    max_range: float = 20.0            # "rangemax" (:114)
    min_range: float = 0.001
    percentage_points_in_c: float = 0.9
    max_angle_diff_deg: float = 3.0    # "maxAngleDiff" (:118)
    max_angle_penalty: float = 0.5     # "maxAnglePenalty" (:119, unused quirk)


@dataclass(frozen=True)
class AmclConfig:
    """AMCL matcher parameters (TPU realization of the reference's
    declared AdaptiveMonteCarloMatching surface; registration/amcl.py)."""

    particles: int = 512
    iterations: int = 8
    sigma_trans: float = 0.25
    sigma_rot: float = 0.17


@dataclass(frozen=True)
class OdomRescueConfig:
    """Odometry-rescue parameters (OdometryAnalyzer plumbing,
    src/ThreadLocalize.cpp:102-103,145-146; velocity limits
    src/ThreadLocalize.h:56-71)."""

    use_odom_rescue: bool = False      # "use_odom_rescue" param
    laser_x: float = 0.0               # static laser-in-base transform
    laser_y: float = 0.0               # (tf lookup in the reference,
    laser_yaw: float = 0.0             #  OdometryAnalyzer.cpp:84-103)
    trns_vel_max: float = 1.5          # TRNS_VEL_MAX
    rot_vel_max: float = 6.28          # ROT_VEL_MAX


@dataclass(frozen=True)
class RegistrationConfig:
    mode: RegMode = RegMode.ICP        # registration_mode param
    trns_thresh: float = 0.25          # TRNS_THRESH: max |t| accepted (ThreadLocalize.h:60)
    rot_thresh: float = 0.17           # ROT_THRESH: max |sin dphi| accepted
    trns_min: float = 0.05             # TRNS_MIN: min motion to re-map (ThreadLocalize.h:64)
    rot_min: float = 0.03              # ROT_MIN
    icp: IcpConfig = field(default_factory=IcpConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    beam_model: BeamModelConfig = field(default_factory=BeamModelConfig)
    amcl: AmclConfig = field(default_factory=AmclConfig)


@dataclass(frozen=True)
class FootprintConfig:
    """Robot footprint freed in the grid at init
    (src/ThreadLocalize.cpp:430-432,503-505)."""

    width: float = 1.0
    height: float = 1.0
    x_offset: float = 0.28


@dataclass(frozen=True)
class RobotConfig:
    """One localizer instance (multi-robot namespacing,
    src/SlamNode.cpp:104-120)."""

    name: str = ""
    local_offset_x: float = 0.0
    local_offset_y: float = 0.0
    local_offset_yaw: float = 0.0
    sensor: SensorConfig = field(default_factory=SensorConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    footprint: FootprintConfig = field(default_factory=FootprintConfig)
    odom: OdomRescueConfig = field(default_factory=OdomRescueConfig)


@dataclass(frozen=True)
class GridPubConfig:
    """Occupancy-grid publisher parameters (src/ThreadGrid.cpp:42-52)."""

    interval_s: float = 2.0            # occ_grid_time_interval (SlamNode.cpp:56)
    pub_tsd_color_map: bool = True
    object_inflation_factor: int = 2
    use_object_inflation: bool = False


@dataclass(frozen=True)
class RuntimeConfig:
    """Host runtime + device options (no reference analogue beyond the
    boost-thread architecture, src/ThreadSLAM.cpp)."""

    dtype: str = "float32"             # compute dtype for grid state
    x_offset: float = 0.0              # x_offset / x_off_factor (SlamNode.cpp:44-52)
    y_offset: float = 0.0
    x_off_factor: float = 0.5
    y_off_factor: float = 0.5


@dataclass(frozen=True)
class SlamConfig:
    grid: GridConfig = field(default_factory=GridConfig)
    robots: List[RobotConfig] = field(default_factory=lambda: [RobotConfig()])
    grid_pub: GridPubConfig = field(default_factory=GridPubConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


# ---------------------------------------------------------------------------
# YAML loading — accepts the reference's parameter names
# ---------------------------------------------------------------------------

def _replace(dc, **kw):
    return dataclasses.replace(dc, **kw)


def _pick(params: Dict[str, Any], prefix: str, name: str, default):
    """Look up `prefix+name` then bare `name` in a flat param dict."""
    if prefix and prefix + name in params:
        return params[prefix + name]
    return params.get(name, default)


def from_flat_params(params: Dict[str, Any]) -> SlamConfig:
    """Build a SlamConfig from a flat dict of reference-style parameter
    names (the ros__parameters payload of config/*.yaml, e.g.
    config/single-laser.yaml)."""
    g = GridConfig(
        map_size=int(params.get("map_size", 10)),
        cellsize=float(params.get("cellsize", 0.025)),
        truncation_radius=float(params.get("truncation_radius", 3.0)),
    )
    if g.map_size > 15:
        # SlamNode.cpp:71-75 rejects map_size > 15
        raise ValueError(f"map_size {g.map_size} > 15 unsupported")

    runtime = RuntimeConfig(
        x_offset=float(params.get("x_offset", 0.0)),
        y_offset=float(params.get("y_offset", 0.0)),
        x_off_factor=float(params.get("x_off_factor", 0.5)),
        y_off_factor=float(params.get("y_off_factor", 0.5)),
    )

    grid_pub = GridPubConfig(
        interval_s=float(params.get("occ_grid_time_interval", 2.0)),
        pub_tsd_color_map=bool(params.get("pub_tsd_color_map", True)),
        object_inflation_factor=int(params.get("object_inflation_factor", 2)),
        use_object_inflation=bool(params.get("use_object_inflation", False)),
    )

    robot_nbr = int(params.get("robot_nbr", 1))
    robots = []
    for i in range(robot_nbr):
        ns = ""
        if robot_nbr > 1:
            name = params.get(f"robot_{i}/name", params.get(f"robot_{i}", {}))
            if isinstance(name, dict):
                name = name.get("name", f"robot{i}")
            ns = str(name) + "/"
        robots.append(_robot_from_params(params, ns))

    return SlamConfig(grid=g, robots=robots, grid_pub=grid_pub, runtime=runtime)


def _robot_from_params(params: Dict[str, Any], ns: str) -> RobotConfig:
    sensor = SensorConfig(
        max_range=float(_pick(params, ns, "max_range", 30.0)),
        min_range=float(_pick(params, ns, "min_range", 0.001)),
        low_reflectivity_range=float(_pick(params, ns, "low_reflectivity_range", 2.0)),
        laser_min_range=float(_pick(params, ns, "laser_min_range", 0.0)),
    )
    icp = IcpConfig(
        iterations=int(_pick(params, ns, "icp_iterations", 25)),
        dist_filter_min=float(_pick(params, ns, "dist_filter_min", 0.2)),
        dist_filter_max=float(_pick(params, ns, "dist_filter_max", 1.0)),
        estimator=str(_pick(params, ns, "icp_estimator", "closed_form")),
    )
    ransac = RansacConfig(
        trials=int(params.get("trials", 100)),
        eps_thresh=float(params.get("epsThresh", 0.15)),
        size_control_set=int(params.get("sizeControlSet", 140)),
        phi_max_deg=float(_pick(params, ns, "ransac_phi_max", 30.0)),
    )
    beam = BeamModelConfig(
        zhit=float(params.get("zhit", 0.45)),
        zphi=float(params.get("zphi", 0.0)),
        zshort=float(params.get("zshort", 0.25)),
        zmax=float(params.get("zmax", 0.05)),
        zrand=float(params.get("zrand", 0.25)),
        sig_hit=float(params.get("sighit", 0.2)),
        sig_phi=float(params.get("sigphi", math.radians(3.0))),
        lam_short=float(params.get("lamshort", 0.08)),
        max_range=float(params.get("rangemax", 20.0)),
        min_range=sensor.min_range,
        percentage_points_in_c=float(
            params.get("percentagePointsInC", 0.9)),
        max_angle_diff_deg=float(params.get("maxAngleDiff", 3.0)),
        max_angle_penalty=float(params.get("maxAnglePenalty", 0.5)),
    )
    reg = RegistrationConfig(
        mode=RegMode(int(_pick(params, ns, "registration_mode", 0))),
        trns_thresh=float(_pick(params, ns, "reg_trs_max", 0.25)),
        rot_thresh=float(_pick(params, ns, "reg_sin_rot_max", 0.17)),
        icp=icp,
        ransac=ransac,
        beam_model=beam,
        amcl=AmclConfig(
            particles=int(_pick(params, ns, "amcl_particles", 512)),
            iterations=int(_pick(params, ns, "amcl_iterations", 8)),
            sigma_trans=float(_pick(params, ns, "amcl_sigma_trans", 0.25)),
            sigma_rot=float(_pick(params, ns, "amcl_sigma_rot", 0.17)),
        ),
    )
    odom = OdomRescueConfig(
        use_odom_rescue=bool(_pick(params, ns, "use_odom_rescue", False)),
        laser_x=float(_pick(params, ns, "laser_x_offset", 0.0)),
        laser_y=float(_pick(params, ns, "laser_y_offset", 0.0)),
        laser_yaw=float(_pick(params, ns, "laser_yaw_offset", 0.0)),
    )
    footprint = FootprintConfig(
        width=float(_pick(params, ns, "footprint_width", 1.0)),
        height=float(_pick(params, ns, "footprint_height", 1.0)),
        x_offset=float(_pick(params, ns, "footprint_x_offset", 0.28)),
    )
    return RobotConfig(
        name=ns.rstrip("/"),
        local_offset_x=float(_pick(params, ns, "local_offset_x", 0.0)),
        local_offset_y=float(_pick(params, ns, "local_offset_y", 0.0)),
        local_offset_yaw=float(_pick(params, ns, "local_offset_yaw", 0.0)),
        sensor=sensor,
        registration=reg,
        footprint=footprint,
        odom=odom,
    )


def load_yaml(path: str) -> SlamConfig:
    """Load a reference-style YAML profile (config/single-laser.yaml).

    Accepts both the ROS 2 layout ({node: {ros__parameters: {...}}}) and a
    flat mapping.
    """
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    params: Dict[str, Any] = {}
    if isinstance(doc, dict):
        # ROS 2 layout: one top-level node name -> ros__parameters
        flat = doc
        for v in doc.values():
            if isinstance(v, dict) and "ros__parameters" in v:
                flat = v["ros__parameters"]
                break
        params = dict(flat)
    return from_flat_params(params)
