"""rospy transport for the live ingestion layer (isdf_tpu/data/
ros_node.py).

The reference's live mode is two rospy nodes (isdf/ros_utils/node.py:21-168):
``iSDFNode`` subscribes to ORB-SLAM3's combined ``/frames`` message
(rgb + depth + camera pose) and ``iSDFFrankaNode`` subscribes to three
separate Franka topics (rgb, depth, end-effector pose) and composes the
latest of each. Both push ``(rgb, depth, T)`` into a size-1 queue read by
the training process.

Here the node logic is split so it stays testable without ROS:

  * pure decoders (`decode_image_msg`, `pose_msg_to_T_WC`,
    `decode_frame_msg`, `compose_franka_frame`) operate on anything
    duck-typed like the ROS messages (``.data``/``.height``/``.width``,
    ``.position``/``.orientation``) — unit-tested without rospy;
  * `ROSFrameSource` / `ROSFrankaSource` are ``produce(put_fn, stop)``
    callables for `live.FrameSourceProcess`, so the transport plugs into
    the same process + drop-stale-queue architecture as every other live
    source. They import rospy only when called, in the producer process —
    exactly where the reference calls ``rospy.init_node``
    (node.py:36-38,114-118).

This file is the full capability match for isdf/ros_utils/node.py; rospy
itself is not a dependency (it is imported where a ROS machine runs it).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from isdf_tpu_torch.data.live import ee_to_cam

# reference node.py:54-60 — calibration black-edge crop margins
CROP_MARGIN_W = 40
CROP_MARGIN_H = 20


def quat_xyzw_to_R(q) -> np.ndarray:
    """ROS geometry_msgs quaternion (x, y, z, w) -> rotation matrix.

    Same algebra as data/replicaCAD_gt_sdf._quat_to_R but in the ROS
    component order (the reference feeds scipy ``Rotation.from_quat``
    which is xyzw, node.py:72)."""
    x, y, z, w = np.asarray(q, np.float64)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _pose_components(pose_msg) -> Tuple[np.ndarray, np.ndarray]:
    p, q = pose_msg.position, pose_msg.orientation
    t = np.array([p.x, p.y, p.z], np.float64)
    R = quat_xyzw_to_R([q.x, q.y, q.z, q.w])
    return R, t


def pose_msg_to_T(pose_msg) -> np.ndarray:
    """geometry_msgs/Pose -> homogeneous 4x4 (no inversion)."""
    R, t = _pose_components(pose_msg)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def pose_msg_to_T_WC(pose_msg) -> np.ndarray:
    """ORB-SLAM3 /frames pose -> camera-to-world transform.

    The wrapper publishes the world-to-camera pose; the reference inverts
    it to get T_WC (node.py:69-76). Inverted in closed form (rigid)."""
    R, t = _pose_components(pose_msg)
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ t
    return T


def decode_image_msg(msg, dtype, channels: Optional[int] = None,
                     crop: bool = False) -> np.ndarray:
    """sensor_msgs/Image raw buffer -> array, with the optional
    calibration-edge crop (reference node.py:46-60)."""
    a = np.frombuffer(msg.data, dtype=dtype)
    shape = ((msg.height, msg.width) if channels is None
             else (msg.height, msg.width, channels))
    a = a.reshape(shape)
    if crop:
        a = a[CROP_MARGIN_H:msg.height - CROP_MARGIN_H,
              CROP_MARGIN_W:msg.width - CROP_MARGIN_W]
    return a


def decode_frame_msg(msg, crop: bool = False) -> dict:
    """ORB-SLAM3 combined frame message -> live-frame dict.

    Matches reference iSDFNode.callback (node.py:40-90): rgb uint8 BGR ->
    RGB, depth raw uint16 (scaling is the dataset's depth transform, as in
    the reference where ROSSubscriber applies it, dataset.py:326-336),
    pose inverted to T_WC."""
    rgb = decode_image_msg(msg.rgb, np.uint8, 3, crop)[..., ::-1]
    depth = decode_image_msg(msg.depth, np.uint16, None, crop)
    return {"image": np.ascontiguousarray(rgb),
            "depth": depth.astype(np.float32),
            "T": pose_msg_to_T_WC(msg.pose).astype(np.float32)}


def _resize(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    from isdf_tpu_torch.utils.image_io import resize_area

    return resize_area(img, wh)


def compose_franka_frame(rgb: Optional[np.ndarray],
                         depth: Optional[np.ndarray],
                         T_cam: Optional[np.ndarray],
                         size_wh: Tuple[int, int] = (1280, 720)) -> Optional[dict]:
    """Combine the latest rgb/depth/pose into one frame, or None if any
    stream has not arrived yet (reference main_callback gating,
    node.py:120-140). rgb arrives BGR and is flipped; both images are
    resized to the working resolution (node.py:126,145)."""
    if rgb is None or depth is None or T_cam is None:
        return None
    rgb = _resize(np.ascontiguousarray(rgb[..., ::-1]), size_wh)
    depth = _resize(depth, size_wh)
    return {"image": rgb, "depth": depth.astype(np.float32),
            "T": np.asarray(T_cam, np.float32)}


class ROSFrameSource:
    """Producer for FrameSourceProcess: subscribe to the ORB-SLAM3
    combined topic and push decoded frames (reference iSDFNode,
    node.py:21-97)."""

    def __init__(self, topic: str = "/frames", crop: bool = False,
                 node_name: str = "isdf"):
        self.topic = topic
        self.crop = crop
        self.node_name = node_name

    def __call__(self, put_fn, stop_event):
        import rospy  # producer-process only, like reference node.py:36
        from orb_slam3_ros_wrapper.msg import frame as FrameMsg

        rospy.init_node(self.node_name, anonymous=True)

        def _cb(msg):
            put_fn(decode_frame_msg(msg, crop=self.crop))

        rospy.Subscriber(self.topic, FrameMsg, _cb, queue_size=1)
        while not stop_event.is_set() and not rospy.is_shutdown():
            time.sleep(0.05)


class ROSFrankaSource:
    """Producer: three Franka topics (rgb / depth / EE pose), hand-eye
    calibrated, combined-latest emission on each rgb arrival (reference
    iSDFFrankaNode, node.py:99-168).

    The EE->camera mapping happens in the pose callback via
    live.ee_to_cam (the same math the reference applies at
    node.py:148-168), so the queue always carries CAMERA poses."""

    def __init__(self, ext_calib,
                 rgb_topic: str = "/franka/rgb",
                 depth_topic: str = "/franka/depth",
                 pose_topic: str = "/franka/pose",
                 size_wh: Tuple[int, int] = (1280, 720),
                 node_name: str = "isdf_franka"):
        self.ext_calib = ext_calib
        self.topics = (rgb_topic, depth_topic, pose_topic)
        self.size_wh = size_wh
        self.node_name = node_name

    def __call__(self, put_fn, stop_event):
        import rospy
        from geometry_msgs.msg import Pose
        from sensor_msgs.msg import Image

        rospy.init_node(self.node_name)
        latest = {"rgb": None, "depth": None, "T": None}

        def _rgb(msg):
            latest["rgb"] = decode_image_msg(msg, np.uint8, 3)
            f = compose_franka_frame(latest["rgb"], latest["depth"],
                                     latest["T"], self.size_wh)
            if f is not None:
                put_fn(f)

        def _depth(msg):
            latest["depth"] = decode_image_msg(msg, np.uint16)

        def _pose(msg):
            latest["T"] = ee_to_cam(pose_msg_to_T(msg), self.ext_calib)

        rgb_t, depth_t, pose_t = self.topics
        rospy.Subscriber(rgb_t, Image, _rgb, queue_size=1)
        rospy.Subscriber(depth_t, Image, _depth, queue_size=1)
        rospy.Subscriber(pose_t, Pose, _pose, queue_size=1)
        while not stop_event.is_set() and not rospy.is_shutdown():
            time.sleep(0.05)


def rospy_available() -> bool:
    try:
        import rospy  # noqa: F401

        return True
    except ImportError:
        return False
