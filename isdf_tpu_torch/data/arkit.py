"""ARKit (iOS LiDAR) ingestion (isdf_tpu/data/arkit.py): the reference's
ARKit dataset rebuilt for the live pipeline.

The reference ships this fully commented out (isdf/datasets/
dataset.py:341-437): an MQTT consumer of two queues where the depth
message is a raw float32 buffer [16 floats column-major ARKit pose |
4 floats fx,fy,cx,cy | 192x256 depth] and the rgb message is an
encoded image. The substantive parts — the wire format and the
ARKit->camera coordinate conversion — are implemented here against the
transport-agnostic live pipeline (data/live.py):

  * ``decode_depth_message`` / ``decode_rgb_message`` — the exact wire
    format of the reference's dead code;
  * ``arkit_pose_to_T_WC`` — ARKit's gravity-aligned, y-up camera
    convention to our z-forward/y-down image frame (the reference's
    180-deg-about-x flip, dataset.py:410-424);
  * ``ARKitQueueSource`` — a producer for FrameSourceProcess consuming
    an MQTT broker when ``pika`` is importable (not a dependency),
    mirroring the reference's x-max-length=3 latest-wins queues;
  * ``ARKitDirectorySource`` — the same decoder over frame*.bin dumps
    (e.g. recorded off the phone), so the format is testable and usable
    without a broker.

Build a dataset with data/live.py::LiveDataset over either source.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

DEPTH_H, DEPTH_W = 192, 256   # ARKit LiDAR depth resolution (reference)


def arkit_pose_to_T_WC(arkit_pose_col_major16: np.ndarray) -> np.ndarray:
    """[16] float32 column-major ARKit camera pose -> T_WC in our image
    frame (z forward, y down).

    Matches the reference's conversion (dataset.py:405-424): transpose
    the column-major buffer, left-multiply the 180-deg-about-x frame
    flip, then offset the x-euler by 180 deg so all rotations start in
    the same range."""
    from scipy.spatial.transform import Rotation

    arkit_pose = np.asarray(arkit_pose_col_major16,
                            np.float64).reshape(4, 4).T
    tf = np.diag([1.0, -1.0, -1.0, 1.0])
    Twc = tf @ arkit_pose
    rot = Rotation.from_matrix(Twc[:3, :3]).as_euler("xyz", degrees=True)
    rot[0] += 180.0
    Twc[:3, :3] = Rotation.from_euler("xyz", rot,
                                      degrees=True).as_matrix()
    return Twc.astype(np.float32)


def decode_depth_message(buf: bytes):
    """Reference wire format (dataset.py:400-407): float32 buffer of
    [16 pose | 4 intrinsics fx,fy,cx,cy | 192*256 depth metres].
    Returns (depth [192,256] f32, T_WC [4,4] f32, intrinsics [4] f32).
    """
    raw = np.frombuffer(buf, dtype=np.float32)
    if raw.size != 20 + DEPTH_H * DEPTH_W:
        raise ValueError(
            f"ARKit depth message has {raw.size} floats, expected "
            f"{20 + DEPTH_H * DEPTH_W} (16 pose + 4 intrinsics + "
            f"{DEPTH_H}x{DEPTH_W} depth)")
    T = arkit_pose_to_T_WC(raw[:16])
    intrinsics = raw[16:20].copy()
    depth = raw[20:].reshape(DEPTH_H, DEPTH_W).copy()
    return depth, T, intrinsics


def decode_rgb_message(buf: bytes):
    """JPEG/PNG-encoded RGB message -> BGR image (the port's imdecode,
    where the reference calls cv2.imdecode)."""
    from isdf_tpu_torch.utils import image_io

    return image_io.imdecode(bytes(buf), image_io.IMREAD_COLOR)


def _frame_from_messages(depth_buf, rgb_buf=None):
    depth, T, intrinsics = decode_depth_message(depth_buf)
    return {"depth": depth, "T": T, "intrinsics": intrinsics,
            "image": (decode_rgb_message(rgb_buf)
                      if rgb_buf is not None else None)}


class ARKitDirectorySource:
    """Producer tailing <dir>/frame*.bin raw depth-message dumps (with
    optional sibling frame*.jpg rgb); drop-stale latest-wins like the
    broker queues."""

    def __init__(self, watch_dir: str, poll_s: float = 0.02):
        self.watch_dir = watch_dir
        self.poll_s = poll_s

    def __call__(self, put_fn, stop_event):
        seen = set()
        while not stop_event.is_set():
            for f in sorted(glob.glob(
                    os.path.join(self.watch_dir, "frame*.bin"))):
                if f in seen:
                    continue
                try:
                    with open(f, "rb") as fh:
                        buf = fh.read()
                    rgb = None
                    jpg = f[:-4] + ".jpg"
                    if os.path.exists(jpg):
                        with open(jpg, "rb") as fh:
                            rgb = fh.read()
                    frame = _frame_from_messages(buf, rgb)
                except Exception:
                    continue  # partially-written file; retry next poll
                seen.add(f)  # only after a successful decode
                put_fn(frame)
            time.sleep(self.poll_s)


class ARKitQueueSource:
    """MQTT producer mirroring the reference's broker setup
    (dataset.py:358-376): rgb_frame + depth_frame queues with
    x-max-length 3, credentials/host from the same env vars. Requires
    ``pika`` (not a dependency: constructing without it raises with a
    clear message; ARKitDirectorySource decodes the same messages)."""

    def __init__(self, host: str = None, user_and_pass: str = None):
        try:
            import pika  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "ARKitQueueSource needs the 'pika' MQTT client; use "
                "ARKitDirectorySource for recorded frames") from e
        self.host = host or os.getenv("rabbitMQBroker", "localhost")
        self.auth = user_and_pass or os.getenv(
            "rabbitMQUserNameAndPassword", "guest")

    def __call__(self, put_fn, stop_event):
        import pika

        credentials = pika.PlainCredentials(self.auth, self.auth)
        conn = pika.BlockingConnection(pika.ConnectionParameters(
            host=self.host, credentials=credentials))
        depth_ch = conn.channel()
        depth_ch.queue_declare(queue="depth_frame",
                               arguments={"x-max-length": 3})
        rgb_ch = conn.channel()
        rgb_ch.queue_declare(queue="rgb_frame",
                             arguments={"x-max-length": 3})
        try:
            while not stop_event.is_set():
                _, _, depth_buf = next(depth_ch.consume(
                    queue="depth_frame", auto_ack=True))
                depth_ch.queue_purge("depth_frame")
                rgb_buf = None
                try:
                    _, _, rgb_buf = next(rgb_ch.consume(
                        queue="rgb_frame", auto_ack=True,
                        inactivity_timeout=0.05))
                except (StopIteration, TypeError):
                    pass
                rgb_ch.queue_purge("rgb_frame")
                put_fn(_frame_from_messages(depth_buf, rgb_buf))
        finally:
            conn.close()
