"""Dataset readers and the factory (isdf_tpu/data/datasets.py; reference
isdf/datasets/dataset.py).

  * ReplicaDataset      — frame%06d.png / depth%06d.png (ndepth for noisy)
                          + traj.txt N x 16 poses (dataset.py:20-71)
  * ScanNetDataset      — frames/color/%d.jpg + frames/depth/%d.png
                          + pose txts (dataset.py:74-121)
  * RealsenseFrankaOffline — rgb jpg + depth .npy + timestamped traj
                          (dataset.py:124-174)
  * SceneCache          — eager every-Nth-frame cache for eval-time
                          visible-region sampling (dataset.py:176-269)
  * StreamDataset       — time-budgeted replay of any dataset, the live
                          stand-in without rospy (dataset.py:273-338)
  * SyntheticDataset    — via data/synthetic.py (format "synthetic")
  * live formats        — realsense / realsense_franka over a watched
                          directory or rospy, and arkit (data/live.py,
                          data/ros_node.py, data/arkit.py)

Every reader emits the reference sample dict {"image", "depth", "T"} with
depth in metres, zero beyond max_depth (isdf/datasets/image_transforms.py).
Images are read by the port's own codec (utils/image_io.py) where isdf_tpu
calls cv2, in cv2's BGR order, so the same bgr_to_rgb flips follow. The
readers are host code: samples are numpy; only the trainer moves them to
its device.
"""

from __future__ import annotations

import os
import time

import numpy as np

from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.utils.config import Config
from isdf_tpu_torch.utils.profiling import span


def undistort_maps(camera_matrix, distortion, w: int, h: int):
    """The source pixel of every output pixel under the Brown-Conrady model
    with coefficients (k1, k2, p1, p2[, k3]): cv2.initUndistortRectifyMap
    with no rectification and the same new camera matrix, as float32 maps
    (map_x, map_y) [h, w]."""
    K = np.asarray(camera_matrix, np.float64)
    d = np.zeros(5)
    dist = np.asarray(distortion, np.float64).reshape(-1)[:5]
    d[:len(dist)] = dist
    k1, k2, p1, p2, k3 = d
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return ((xd * fx + cx).astype(np.float32),
            (yd * fy + cy).astype(np.float32))


def remap_nearest(img: np.ndarray, map_x: np.ndarray,
                  map_y: np.ndarray) -> np.ndarray:
    """cv2.remap with INTER_NEAREST and a constant-0 border: the source
    pixel is the map rounded half to even, as cv2 rounds it."""
    xi = np.rint(map_x).astype(np.int64)
    yi = np.rint(map_y).astype(np.int64)
    h, w = img.shape[:2]
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros(map_x.shape + img.shape[2:], img.dtype)
    out[ok] = img[yi[ok], xi[ok]]
    return out


class DepthTransform:
    """depth * 1/scale, zero beyond max_depth, optional undistortion
    (reference image_transforms.py:19-38 + dataset.py:326-331). isdf_tpu
    undistorts only where cv2 imports; the port always does, so it equals
    isdf_tpu running with cv2."""

    def __init__(self, inv_scale: float, max_depth: float,
                 camera_matrix=None, distortion=None):
        self.inv_scale = inv_scale
        self.max_depth = max_depth
        self.maps = None
        if distortion and camera_matrix is not None:
            self.camera_matrix = np.asarray(camera_matrix, np.float64)
            self.distortion = np.asarray(distortion, np.float64)

    def __call__(self, depth):
        with span("data.depth_transform"):
            d = depth.astype(np.float32) * self.inv_scale
            if getattr(self, "distortion", None) is not None:
                if self.maps is None:
                    h, w = d.shape
                    self.maps = undistort_maps(self.camera_matrix,
                                               self.distortion, w, h)
                d = remap_nearest(d, *self.maps)
            d[d > self.max_depth] = 0.0
            return d


def camera_depth_transform(config: Config) -> DepthTransform:
    """DepthTransform (mm scaling + undistortion) from config.camera: the
    one construction shared by the offline realsense reader and the live
    realsense/franka branches of make_dataset."""
    cam = config.camera
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                  [0.0, 0.0, 1.0]])
    return DepthTransform(
        1.0 / config.depth_scale, config.max_depth,
        camera_matrix=K, distortion=list(cam.distortion) or None)


def bgr_to_rgb(im):
    return im[..., ::-1]


def load_traj(path: str, timestamped: bool = False) -> np.ndarray:
    """traj.txt rows of 16 floats -> [N, 4, 4] (timestamped: the first
    column is a timestamp; reference dataset.py:141-147)."""
    Ts = np.loadtxt(path).reshape(-1, 17 if timestamped else 16)
    if timestamped:
        Ts = Ts[:, 1:]
    return Ts.reshape(-1, 4, 4).astype(np.float32)


class ReplicaDataset:
    """Replica / ReplicaCAD sequence directory (reference dataset.py:20-71)."""

    def __init__(self, seq_dir: str, config: Config, col_ext: str = ".png"):
        self.root = os.path.join(seq_dir, "results")
        self.Ts = load_traj(os.path.join(seq_dir, "traj.txt"))
        self.depth_transform = DepthTransform(
            1.0 / config.depth_scale, config.max_depth)
        self.col_ext = col_ext
        self.noisy = config.noisy_depth
        self.cfg = config

    def __len__(self):
        return self.Ts.shape[0]

    def __getitem__(self, idx):
        idx = int(idx)
        dname = "ndepth" if self.noisy else "depth"
        with span("data.frame"):
            depth = IO.imread(os.path.join(self.root,
                                           f"{dname}{idx:06d}.png"),
                              IO.IMREAD_UNCHANGED)
            image = bgr_to_rgb(IO.imread(
                os.path.join(self.root, f"frame{idx:06d}{self.col_ext}")))
            return {"image": image,
                    "depth": self.depth_transform(depth),
                    "T": self.Ts[idx]}


class ScanNetDataset:
    """Exported ScanNet scene (reference dataset.py:74-121)."""

    def __init__(self, scannet_dir: str, config: Config):
        self.root = os.path.join(scannet_dir, "frames")
        self.depth_transform = DepthTransform(
            1.0 / config.depth_scale, config.max_depth)
        pose_dir = os.path.join(self.root, "pose")
        n = len([f for f in os.listdir(pose_dir) if f.endswith(".txt")])
        self.Ts = np.stack([
            np.loadtxt(os.path.join(pose_dir, f"{i}.txt")).astype(np.float32)
            for i in range(n)])

    def __len__(self):
        return self.Ts.shape[0]

    def __getitem__(self, idx):
        idx = int(idx)
        with span("data.frame"):
            depth = IO.imread(os.path.join(self.root, "depth", f"{idx}.png"),
                              IO.IMREAD_UNCHANGED)
            image = bgr_to_rgb(IO.imread(
                os.path.join(self.root, "color", f"{idx}.jpg")))
            return {"image": image,
                    "depth": self.depth_transform(depth),
                    "T": self.Ts[idx]}


class RealsenseFrankaOffline:
    """Recorded Franka sequence: rgb jpg + depth npy + timestamped traj
    (reference dataset.py:124-174)."""

    def __init__(self, seq_dir: str, config: Config):
        self.root = seq_dir
        self.Ts = load_traj(os.path.join(seq_dir, "traj.txt"),
                            timestamped=True)
        self.depth_transform = camera_depth_transform(config)

    def __len__(self):
        return self.Ts.shape[0]

    def __getitem__(self, idx):
        idx = int(idx)
        with span("data.frame"):
            with span("data.file_read"):
                depth = np.load(os.path.join(self.root,
                                             f"depth{idx:06d}.npy"))
            image = bgr_to_rgb(IO.imread(
                os.path.join(self.root, f"frame{idx:06d}.jpg")))
            return {"image": image,
                    "depth": self.depth_transform(depth),
                    "T": self.Ts[idx]}


class SceneCache:
    """Eagerly cache every ``skip``-th frame for eval-time visible-region
    sampling (reference dataset.py:176-269 + eval_pts.py:421-424)."""

    def __init__(self, dataset, skip: int = 5):
        self.dataset = dataset
        self.skip = skip
        self._cache = {}

    def __len__(self):
        return len(self.dataset)

    def _frame(self, i):
        i = (int(i) // self.skip) * self.skip
        i = min(i, len(self.dataset) - 1)
        if i not in self._cache:
            s = self.dataset[i]
            self._cache[i] = (s["depth"], s["T"])
        return self._cache[i]

    def __getitem__(self, idxs):
        idxs = np.atleast_1d(np.asarray(idxs))
        # the cached frames covering the requested range, each once
        keys = sorted({(int(i) // self.skip) * self.skip for i in idxs})
        keys = [min(k, len(self.dataset) - 1) for k in keys]
        depths, Ts = zip(*[self._frame(k) for k in keys]) if keys else ((), ())
        return {"depth": np.stack(depths) if depths else np.zeros((0, 1, 1)),
                "T": np.stack(Ts) if Ts else np.zeros((0, 4, 4))}

    def get_all(self):
        return self[np.arange(0, len(self.dataset), self.skip)]


class StreamDataset:
    """Live-mode stand-in: replays an underlying dataset in real time.

    The reference's ROS path crosses a process boundary via a size-1
    multiprocessing queue and always trains on the latest frame
    (dataset.py:294-338, ros_utils/node.py:182-195). Here any index maps
    to the latest frame by wall clock, with the same drop-stale semantics;
    no rospy dependency."""

    def __init__(self, dataset, fps: float = 30.0):
        self.dataset = dataset
        self.fps = fps
        self.t0 = time.perf_counter()

    def __len__(self):
        return len(self.dataset)

    def camera(self):
        return self.dataset.camera()

    def __getitem__(self, _idx):
        i = int((time.perf_counter() - self.t0) * self.fps)
        i = min(i, len(self.dataset) - 1)
        return self.dataset[i]


def _live_camera(cam) -> dict:
    return dict(H=cam.h, W=cam.w, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                cy=cam.cy)


def make_dataset(config: Config, device="cpu"):
    """The dataset of ``config.dataset_format``. ``device``: where the
    synthetic scene renders its depth (the other formats read files)."""
    fmt = config.dataset_format
    if fmt == "synthetic":
        from isdf_tpu_torch.data.synthetic import (SCENE_PRESETS,
                                                   SyntheticDataset,
                                                   make_scene)
        preset = "room_a"
        if config.seq_dir:
            name = [x for x in config.seq_dir.split("/") if x][-1]
            if name in SCENE_PRESETS:
                preset = name
        cam = config.camera
        return SyntheticDataset(
            make_scene(preset), n_frames=400, H=cam.h, W=cam.w,
            hfov_deg=float(2 * np.degrees(np.arctan(cam.w / (2 * cam.fx)))),
            max_depth=config.max_depth, pose_noise_std=config.pose_noise_std,
            pose_noise_mode=config.pose_noise_mode, device=device)
    if fmt in ("replica", "replicaCAD"):
        ext = ".png" if fmt == "replicaCAD" else ".jpg"
        return ReplicaDataset(config.seq_dir, config, col_ext=ext)
    if fmt == "ScanNet":
        return ScanNetDataset(config.scannet_dir, config)
    if fmt == "realsense_franka_offline":
        return RealsenseFrankaOffline(config.seq_dir, config)
    if fmt in ("realsense", "realsense_franka"):
        # live mode: the reference runs a rospy node in its own process
        # feeding a size-1 queue (isdf/ros_utils/node.py:21-195,
        # isdf/datasets/dataset.py:273-338). The same architecture with a
        # transport-agnostic producer: a DirectoryWatchSource tailing
        # dataset.live_dir for frame*.npz files {depth, T[, image]}
        # dropped by any bridge (a ROS relay, a recorder, a test).
        # realsense frames carry CAMERA poses; realsense_franka frames
        # carry END-EFFECTOR poses mapped through the hand-eye
        # calibration (config ext_calib, node.py:162-168).
        from isdf_tpu_torch.data.live import (DirectoryWatchSource,
                                              FrameSourceProcess,
                                              LiveDataset)
        transform = camera_depth_transform(config)
        if config.live_transport == "ros":
            # the reference's own transport (node.py:21-168): a rospy node
            # in the producer process. The Franka source applies the
            # hand-eye calibration itself, so the dataset must not.
            from isdf_tpu_torch.data import ros_node
            if fmt == "realsense_franka":
                produce = ros_node.ROSFrankaSource(config.ext_calib)
            else:
                produce = ros_node.ROSFrameSource()
            source = FrameSourceProcess(produce).start()
            return LiveDataset(source, camera=_live_camera(config.camera),
                               depth_transform=transform)
        if not config.live_dir:
            raise ValueError(
                f"{fmt!r} is a live format: set dataset.live_dir to the "
                "directory a bridge process drops frame*.npz files into "
                "(or dataset.live_transport='ros' on a ROS machine)")
        source = FrameSourceProcess(
            DirectoryWatchSource(config.live_dir)).start()
        return LiveDataset(
            source, camera=_live_camera(config.camera),
            depth_transform=transform,
            ext_calib=(config.ext_calib if fmt == "realsense_franka"
                       else None))
    if fmt == "arkit":
        # iOS LiDAR live mode (the reference ships this dataset commented
        # out, isdf/datasets/dataset.py:341-437): frames arrive as
        # frame*.bin raw depth-message dumps in live_dir
        # (ARKitDirectorySource), or from an MQTT broker through
        # ARKitQueueSource where pika is installed
        from isdf_tpu_torch.data.arkit import ARKitDirectorySource
        from isdf_tpu_torch.data.live import FrameSourceProcess, LiveDataset
        if not config.live_dir:
            raise ValueError(
                "'arkit' is a live format: set dataset.live_dir to the "
                "directory frame*.bin depth messages are dropped into")
        source = FrameSourceProcess(
            ARKitDirectorySource(config.live_dir)).start()
        return LiveDataset(
            source, camera=_live_camera(config.camera),
            depth_transform=DepthTransform(1.0 / config.depth_scale,
                                           config.max_depth))
    raise ValueError(f"unsupported dataset format {fmt!r}")
