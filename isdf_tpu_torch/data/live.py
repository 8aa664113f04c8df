"""Live frame sources, the ROS-equivalent ingestion layer
(isdf_tpu/data/live.py).

The reference's live mode runs a rospy node in a separate process and
passes frames through a size-1 multiprocessing queue, training always on
the LATEST frame (isdf/ros_utils/node.py:21-195,
isdf/datasets/dataset.py:273-338). rospy does not exist here; the same
architecture is provided transport-agnostically:

  * LatestFrameQueue — the drop-stale size-1 queue contract;
  * FrameSourceProcess — a producer process pushing frames into it;
  * LiveDataset — dataset adapter: index 0 == latest frame (blocking until
    the first frame arrives), exactly like the reference's ROSSubscriber;
  * DirectoryWatchSource — a producer that tails a directory where an
    external system (e.g. a ROS bridge outside this process) drops
    frame<i>.npz files {depth, T [, image]};
  * rospy integration hooks are kept importable-on-demand: pass your own
    ``produce(queue)`` callable wrapping any middleware.

A Franka-style recorder (reference realsense_franka_data_gen.py) is
``record_frames`` — drains a source to disk in the offline format, its
colour as JPEG through the port's codec (utils/image_io.py).

The producer side (FrameSourceProcess._run and the sources it runs) is
numpy only: the process is forked, and a CUDA context of the parent must
not be touched there.
"""

from __future__ import annotations

import glob
import os
import queue as _queue
import time
from multiprocessing import Event, Process, Queue
from typing import Callable, Dict, Optional

import numpy as np


class LatestFrameQueue:
    """Size-1 queue with drop-stale semantics (reference node.py:182-195:
    get_latest_frame drains the queue and keeps the newest item)."""

    def __init__(self, mp_queue: Optional[Queue] = None):
        self.q = mp_queue if mp_queue is not None else Queue(maxsize=1)

    def put_latest(self, item):
        while True:
            try:
                self.q.put_nowait(item)
                return
            except _queue.Full:
                try:
                    self.q.get_nowait()
                except _queue.Empty:
                    pass

    def get_latest(self, block: bool = True, timeout: float = 30.0):
        item = self.q.get(block=block, timeout=timeout)
        while True:  # drain to newest
            try:
                item = self.q.get_nowait()
            except _queue.Empty:
                return item


class FrameSourceProcess:
    """Run ``produce(put_fn, stop_event)`` in a separate process, like the
    reference's mp.Process(iSDFNode) (dataset.py:294-308)."""

    def __init__(self, produce: Callable):
        self.queue = LatestFrameQueue()
        self.stop = Event()
        self.proc = Process(target=self._run, args=(produce,), daemon=True)

    def _run(self, produce):
        produce(self.queue.put_latest, self.stop)

    def start(self):
        self.proc.start()
        return self

    def close(self):
        self.stop.set()
        self.proc.join(timeout=2)
        if self.proc.is_alive():
            # a producer busy past its stop check: end it and reap it
            self.proc.terminate()
            self.proc.join(timeout=5)


class DirectoryWatchSource:
    """Producer tailing <dir>/frame*.npz files with keys depth, T[, image]."""

    def __init__(self, watch_dir: str, poll_s: float = 0.02):
        self.watch_dir = watch_dir
        self.poll_s = poll_s

    def __call__(self, put_fn, stop_event):
        seen = set()
        while not stop_event.is_set():
            for f in sorted(glob.glob(
                    os.path.join(self.watch_dir, "frame*.npz"))):
                if f in seen:
                    continue
                seen.add(f)
                try:
                    with np.load(f) as z:
                        frame = {"depth": z["depth"].astype(np.float32),
                                 "T": z["T"].astype(np.float32),
                                 "image": (z["image"] if "image" in z
                                           else None)}
                    put_fn(frame)
                except Exception:
                    pass  # partially-written file; retry next poll
            time.sleep(self.poll_s)


def ee_to_cam(T_ee: np.ndarray, ext_calib) -> np.ndarray:
    """End-effector pose -> camera pose via the hand-eye calibration.

    Matches reference iSDFFrankaNode.ee_to_cam (ros_utils/node.py:162-168):
    ext_calib is the config's list whose first entry carries
    ``camera_ee_pos`` (camera position in the EE frame) and
    ``camera_ee_ori_rotvec`` (camera orientation as a rotation vector).
    """
    from scipy.spatial.transform import Rotation

    cal = ext_calib[0] if isinstance(ext_calib, (list, tuple)) else ext_calib
    cam_ee_pos = np.asarray(cal["camera_ee_pos"], np.float64)
    cam_ee_rot = Rotation.from_rotvec(
        np.asarray(cal["camera_ee_ori_rotvec"], np.float64)).as_matrix()

    T_ee = np.asarray(T_ee, np.float64)
    R_ee, t_ee = T_ee[:3, :3], T_ee[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R_ee @ cam_ee_rot
    out[:3, 3] = t_ee + R_ee @ cam_ee_pos
    return out.astype(np.float32)


class LiveDataset:
    """Dataset adapter over a live source: any index returns the latest
    frame (reference ROSSubscriber.__getitem__, dataset.py:313-338).

    ext_calib: when the stream carries END-EFFECTOR poses (Franka), the
    hand-eye calibration is applied on ingest (reference
    node.py:142-168)."""

    def __init__(self, source: FrameSourceProcess, camera: Dict,
                 n_frames: int = 10 ** 9,
                 depth_transform: Optional[Callable] = None,
                 ext_calib=None):
        self.source = source
        self._camera = camera
        self.n_frames = n_frames
        self.depth_transform = depth_transform
        self.ext_calib = ext_calib
        self._last = None

    def camera(self):
        return self._camera

    def __len__(self):
        return self.n_frames

    def __getitem__(self, _idx):
        try:
            frame = self.source.queue.get_latest(timeout=30.0)
            self._last = frame
        except _queue.Empty:
            if self._last is None:
                raise TimeoutError("no live frame within 30s")
            frame = self._last
        depth = frame["depth"]
        if self.depth_transform is not None:
            depth = self.depth_transform(depth)
        T = frame["T"]
        if self.ext_calib is not None:
            T = ee_to_cam(T, self.ext_calib)
        return {"image": frame.get("image"), "depth": depth, "T": T}


def record_frames(dataset, out_dir: str, n_frames: int, fps: float = 30.0):
    """Record a (live) dataset to the realsense_franka_offline on-disk
    format (reference realsense_franka_data_gen.py:35-72)."""
    from isdf_tpu_torch.utils import image_io

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i in range(n_frames):
        t0 = time.perf_counter()
        s = dataset[0]
        np.save(os.path.join(out_dir, f"depth{i:06d}.npy"), s["depth"])
        if s.get("image") is not None:
            image_io.imwrite(os.path.join(out_dir, f"frame{i:06d}.jpg"),
                             s["image"][..., ::-1])
        rows.append(np.concatenate([[time.time()],
                                    np.asarray(s["T"]).reshape(16)]))
        dt = 1.0 / fps - (time.perf_counter() - t0)
        if dt > 0:
            time.sleep(dt)
    np.savetxt(os.path.join(out_dir, "traj.txt"), np.stack(rows))
