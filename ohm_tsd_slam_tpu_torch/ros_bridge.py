"""Optional ROS 2 bridge (port of ohm_tsd_slam_tpu/ros_bridge.py): the
reference's topic and service surface on the port's SlamNode.

The reference node (src/SlamNode.cpp, launch/slam.launch.py) exposes:
  in:   <robot>/laser           sensor_msgs/LaserScan
        tf (laser->footprint->odom lookups for the map->odom correction,
        src/ThreadLocalize.cpp:604-689)
  out:  <robot>/estimated_pose  geometry_msgs/PoseStamped
        map                     nav_msgs/OccupancyGrid
        map/image               sensor_msgs/Image (RGB TSD colormap)
        tf map->odom
  srv:  start_stop_slam (srv/StartStopSLAM.srv), <node>/get_map

This module reproduces that surface on top of SlamNode when `rclpy` is
importable (a ROS 2 Humble environment); the rest of the package never
imports it, so the library stays free of ROS.  Without rclpy, `main()`
prints why and returns 1.  The node runs on the card unless `device`
asks for another (SlamNode's rule).
"""

from __future__ import annotations

import math
from typing import Optional

try:
    import rclpy  # type: ignore
    from rclpy.node import Node  # type: ignore

    HAVE_ROS = True
except Exception:  # pragma: no cover - no ROS in CI image
    HAVE_ROS = False
    Node = object  # type: ignore


class RosSlamBridge(Node):  # pragma: no cover - needs rclpy runtime
    """rclpy node wiring SlamNode to the reference's topics."""

    def __init__(self, config=None, device=None):
        from sensor_msgs.msg import Image, LaserScan  # type: ignore
        from geometry_msgs.msg import PoseStamped  # type: ignore
        from nav_msgs.msg import OccupancyGrid  # type: ignore
        from nav_msgs.srv import GetMap  # type: ignore
        from std_srvs.srv import SetBool  # type: ignore

        super().__init__("slam_node")
        import numpy as np

        from ohm_tsd_slam_tpu_torch.config import from_flat_params
        from ohm_tsd_slam_tpu_torch.slam import messages
        from ohm_tsd_slam_tpu_torch.slam.node import SlamNode

        self._np = np
        self._messages = messages
        if config is None:
            # mirror SlamNode.cpp:40-67: parameters from the ROS param
            # server
            names = ["robot_nbr", "map_size", "cellsize",
                     "truncation_radius", "occ_grid_time_interval",
                     "registration_mode", "icp_iterations", "max_range",
                     "min_range", "laser_min_range", "x_offset",
                     "y_offset"]
            params = {}
            for n in names:
                try:
                    self.declare_parameter(n)
                    v = self.get_parameter(n).value
                    if v is not None:
                        params[n] = v
                except Exception:
                    pass
            config = from_flat_params(params)
        self.slam = SlamNode(config, device=device)

        self._scan_sub = self.create_subscription(
            LaserScan, "laser", self._on_scan, 1)
        self._pose_pub = self.create_publisher(PoseStamped,
                                               "estimated_pose", 1)
        self._map_pub = self.create_publisher(OccupancyGrid, "map", 1)
        self._img_pub = self.create_publisher(Image, "map/image", 1)
        self._map_srv = self.create_service(GetMap, "get_map",
                                            self._on_get_map)
        # start_stop_slam (srv/StartStopSLAM.srv: uint8 start_stop) is a
        # custom type in the reference package; SetBool carries the same
        # bit without requiring the generated interface
        self._ss_srv = self.create_service(SetBool, "start_stop_slam",
                                           self._on_start_stop)
        interval = config.grid_pub.interval_s
        self._timer = self.create_timer(interval, self._publish_map)

        # tf map->odom broadcast (sendTransform, ThreadLocalize.cpp:
        # 604-689); optional — tf2_ros may be absent in minimal images
        self._tf_broadcaster = None
        try:
            from tf2_ros import TransformBroadcaster  # type: ignore

            self._tf_broadcaster = TransformBroadcaster(self)
            self.slam.tf_callbacks.append(self._on_tf)
        except Exception:
            pass

    def _on_tf(self, robot, tf):
        from geometry_msgs.msg import TransformStamped  # type: ignore

        m = TransformStamped()
        m.header.frame_id = tf.parent_frame
        m.child_frame_id = tf.child_frame
        m.header.stamp.sec = int(tf.stamp)
        m.header.stamp.nanosec = int((tf.stamp - int(tf.stamp)) * 1e9)
        m.transform.translation.x = tf.x
        m.transform.translation.y = tf.y
        m.transform.rotation.z = math.sin(tf.theta / 2.0)
        m.transform.rotation.w = math.cos(tf.theta / 2.0)
        self._tf_broadcaster.sendTransform(m)

    def _on_scan(self, msg):
        scan = self._messages.LaserScan(
            ranges=self._np.asarray(msg.ranges, self._np.float64),
            angle_min=msg.angle_min,
            angle_increment=msg.angle_increment,
            range_max=msg.range_max,
            stamp=msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9)
        out = self.slam.process_scan(0, scan)
        if out is None:
            return
        from geometry_msgs.msg import PoseStamped  # type: ignore

        p = PoseStamped()
        p.header.frame_id = "map"
        p.header.stamp = msg.header.stamp
        p.pose.position.x = out.x
        p.pose.position.y = out.y
        p.pose.orientation.z = math.sin(out.theta / 2.0)
        p.pose.orientation.w = math.cos(out.theta / 2.0)
        self._pose_pub.publish(p)

    def _occ_msg(self):
        from nav_msgs.msg import OccupancyGrid  # type: ignore

        occ, img = self.slam.publish_map()
        m = OccupancyGrid()
        m.header.frame_id = "map"
        m.info.resolution = float(self.slam.config.grid.cellsize)
        m.info.width = occ.width
        m.info.height = occ.height
        m.info.origin.position.x = occ.origin_x
        m.info.origin.position.y = occ.origin_y
        m.data = [int(v) for v in self._np.asarray(occ.data).ravel()]
        return m, img

    def _publish_map(self):
        m, img = self._occ_msg()
        self._map_pub.publish(m)
        if img is not None:
            from sensor_msgs.msg import Image  # type: ignore

            i = Image()
            i.header.frame_id = "map"
            arr = self._np.asarray(img.data)
            i.height, i.width = arr.shape[0], arr.shape[1]
            i.encoding = "rgb8"
            i.step = arr.shape[1] * 3
            i.data = arr.tobytes()
            self._img_pub.publish(i)

    def _on_get_map(self, request, response):
        response.map, _ = self._occ_msg()
        return response

    def _on_start_stop(self, request, response):
        self.slam.set_active(bool(request.data))
        response.success = True
        return response


def main(config: Optional[str] = None, device=None) -> int:
    if not HAVE_ROS:
        print("ros_bridge: rclpy not available in this environment; "
              "install ROS 2 (Humble) or use `python -m "
              "ohm_tsd_slam_tpu_torch run` with a scan log instead")
        return 1
    cfg = None
    if config:
        from ohm_tsd_slam_tpu_torch.config import load_yaml

        cfg = load_yaml(config)
    rclpy.init()
    node = RosSlamBridge(cfg, device=device)
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()
    return 0
