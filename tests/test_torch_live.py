"""The port's live sources, recorder, ROS and ARKit adapters, asset
loaders, GT-SDF composer and trajectory writer against isdf_tpu's, on the
CPU: isdf_tpu's own cases (tests/test_live.py, test_ros_node.py,
test_assets.py), run on the port and, where a function has an output,
compared with isdf_tpu's on the same inputs.
"""

import os
import threading
import time
import types
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from isdf_tpu.data import arkit as JA
from isdf_tpu.data import assets as JAS
from isdf_tpu.data import live as JL
from isdf_tpu.data import ros_node as JR
from isdf_tpu_torch.data import arkit as TA
from isdf_tpu_torch.data import assets as TAS
from isdf_tpu_torch.data import live as TL
from isdf_tpu_torch.data import ros_node as TR

from test_assets import TRI_F, TRI_V, _write_glb, _write_obj
from test_live import _write_frame
from test_ros_node import _img_msg, _pose_msg, _rand_quat, _StubRospy, \
    _run_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAL = [{"camera_ee_pos": [0.1, 0.0, 0.05],
        "camera_ee_ori_rotvec": [0.0, 0.0, np.pi / 2]}]


# ---------------------------------------------------------------------------
# live sources
# ---------------------------------------------------------------------------

def test_directory_watch_live_pipeline(tmp_path):
    d = str(tmp_path)
    _write_frame(d, 0, 1.0)
    src = TL.FrameSourceProcess(TL.DirectoryWatchSource(d, poll_s=0.01)
                                ).start()
    try:
        ds = TL.LiveDataset(src, camera=dict(H=16, W=24, fx=10.0, fy=10.0,
                                             cx=12.0, cy=8.0))
        s = ds[0]
        assert s["depth"].shape == (16, 24)
        assert float(s["depth"][0, 0]) in (1.0, 2.0, 3.0)
        for i in range(1, 4):
            _write_frame(d, i, float(i + 1))
        deadline, s = time.time() + 10, s
        while time.time() < deadline and float(s["depth"][0, 0]) != 4.0:
            s = ds[0]
            time.sleep(0.05)
        assert float(s["depth"][0, 0]) == 4.0     # the newest frame won
        assert float(s["T"][0, 3]) == pytest.approx(0.03)
    finally:
        src.close()
    assert not src.proc.is_alive()


def test_latest_frame_queue_drops_stale():
    q = TL.LatestFrameQueue()
    for i in range(5):
        q.put_latest(i)
    assert q.get_latest(timeout=1.0) == 4


def test_record_frames_both_ways(tmp_path):
    """The port's recording reads in isdf_tpu's offline reader and
    isdf_tpu's in the port's, to the same depth and pose and to JPEG
    colour within max 4 / mean 0.5 levels."""
    from isdf_tpu.data.datasets import RealsenseFrankaOffline as JOff
    from isdf_tpu.utils.config import Config as JConfig
    from isdf_tpu_torch.data.datasets import RealsenseFrankaOffline as TOff
    from isdf_tpu_torch.utils.config import Config as TConfig
    cv2 = pytest.importorskip("cv2")  # isdf_tpu records its JPEG with cv2
    assert cv2 is not None
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:24, 0:32]

    class FakeLive:
        i = 0

        def __getitem__(self, _):
            self.i += 1
            img = np.stack([xx * 7, yy * 9, (xx + yy) * 3 + 10 * self.i],
                           -1).astype(np.uint8)
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = rng.normal(size=3)
            return {"image": img, "T": T,
                    "depth": rng.uniform(200, 1500, (24, 32)).astype(
                        np.float32)}

    for rec in (TL.record_frames, JL.record_frames):
        out = str(tmp_path / rec.__module__.split(".")[0])
        rec(FakeLive(), out, n_frames=3, fps=1000.0)
        traj = np.loadtxt(os.path.join(out, "traj.txt"))
        assert traj.shape == (3, 17)
        a = TOff(out, TConfig().replace(depth_scale=1000.0))
        b = JOff(out, JConfig().replace(depth_scale=1000.0))
        assert len(a) == len(b) == 3
        for i in range(3):
            np.testing.assert_array_equal(a[i]["depth"], b[i]["depth"])
            np.testing.assert_array_equal(a[i]["T"], b[i]["T"])
            d = np.abs(a[i]["image"].astype(int) - b[i]["image"])
            assert d.max() <= 4 and d.mean() <= 0.5


def test_stream_dataset_replays_by_wallclock():
    from isdf_tpu_torch.data.datasets import StreamDataset

    class Seq:
        def __len__(self):
            return 100

        def camera(self):
            return {"H": 1}

        def __getitem__(self, i):
            return {"idx": int(i)}

    sd = StreamDataset(Seq(), fps=1000.0)
    first = sd[0]["idx"]
    time.sleep(0.05)
    assert sd[0]["idx"] > first and sd.camera() == {"H": 1}
    assert len(sd) == 100


def test_ee_to_cam_equals_isdf_tpu():
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(1)
    for _ in range(5):
        T_ee = np.eye(4, dtype=np.float32)
        T_ee[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
        T_ee[:3, 3] = rng.normal(size=3)
        got = TL.ee_to_cam(T_ee, CAL)
        np.testing.assert_array_equal(got, JL.ee_to_cam(T_ee, CAL))
        assert got.dtype == np.float32

    class FakeSource:
        class queue:
            @staticmethod
            def get_latest(timeout=None):
                return {"depth": np.ones((4, 4), np.float32), "T": T_ee}

    out = TL.LiveDataset(FakeSource(), camera={}, ext_calib=CAL)[0]
    np.testing.assert_array_equal(out["T"], JL.ee_to_cam(T_ee, CAL))


def test_make_dataset_for_the_live_configs(tmp_path):
    """realsense.json and realsense_franka.json build live datasets over
    live_dir with the config's camera, undistortion and calibration, as
    in isdf_tpu; the ros transport wires without rospy (its producer
    dies at import, so no frame ever arrives)."""
    import queue as _queue

    from isdf_tpu_torch.data.datasets import make_dataset
    from isdf_tpu_torch.utils.config import Config, load_config
    base = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs")
    for name, fmt, has_cal in (("realsense.json", "realsense", False),
                               ("realsense_franka.json", "realsense_franka",
                                True)):
        cfg = load_config(os.path.join(base, name))
        assert cfg.dataset_format == fmt and cfg.live
        cfg = cfg.replace(live_dir=str(tmp_path))
        ds = make_dataset(cfg)
        try:
            assert isinstance(ds, TL.LiveDataset)
            assert ds.camera()["W"] == 1280
            assert (ds.ext_calib is not None) == has_cal
            if has_cal:
                assert "camera_ee_pos" in ds.ext_calib[0]
                assert cfg.workspace_extents is not None
            else:
                assert ds.depth_transform.distortion is not None
        finally:
            ds.source.close()
    with pytest.raises(ValueError, match="live_dir"):
        make_dataset(Config().replace(dataset_format="realsense"))
    assert not TR.rospy_available()
    ds = make_dataset(Config().replace(dataset_format="realsense",
                                       live_transport="ros"))
    try:
        with pytest.raises(_queue.Empty):
            ds.source.queue.q.get(timeout=0.5)
    finally:
        ds.source.close()


def test_live_trainer_loss_falls(tmp_path):
    """A producer process drops wall frames into live_dir; make_dataset
    wires the watch -> queue -> LiveDataset pipeline; the port's Trainer
    ingests them and learns the wall (isdf_tpu tests/test_live.py:127)."""
    from isdf_tpu_torch.data.datasets import make_dataset
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import config_from_dict
    d = str(tmp_path)
    H, W = 24, 32
    rng = np.random.default_rng(0)

    def drop(i):
        depth = np.full((H, W), 2000 + 40 * rng.standard_normal((H, W)),
                        np.uint16)
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.02 * (i % 6)
        tmp = os.path.join(d, f".tmp{i}.npz")
        np.savez(tmp, depth=depth, T=T)
        os.replace(tmp, os.path.join(d, f"frame{i:04d}.npz"))

    # a camera: a new frame every 50 ms while the trainer runs (a
    # LiveDataset read waits for the next frame)
    stop = threading.Event()

    def camera():
        i = 0
        while not stop.is_set():
            drop(i)
            i += 1
            stop.wait(0.05)

    cam_thread = threading.Thread(target=camera, daemon=True)
    cam_thread.start()
    cfg = config_from_dict({
        "dataset": {"format": "realsense", "live_dir": d,
                    "depth_scale": 1000.0, "fps": 30,
                    "camera": {"w": W, "h": H, "fx": 20.0, "fy": 20.0,
                               "cx": W / 2, "cy": H / 2}},
        "sample": {"n_rays": 15, "n_rays_is_kf": 30, "n_strat_samples": 5,
                   "n_surf_samples": 2, "depth_range": [0.15, 3.0]},
        "model": {"iters_per_frame": 10, "iters_per_kf": 20,
                  "window_size": 3, "hidden_layers_block": 1,
                  "hidden_feature_size": 64},
        "eval": {"do_eval": 0},
    })
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    ds = make_dataset(cfg)
    try:
        tr = Trainer(cfg, dataset=ds, seed=0, device="cpu")
        probe = np.stack([np.zeros(8), np.zeros(8),
                          np.linspace(0.5, 1.9, 8)], 1).astype(np.float32)
        gt = 2.0 - probe[:, 2]

        def mae():
            return float(np.abs(tr.sdf_fn(probe).reshape(-1) - gt).mean())

        before = mae()
        train_loop(tr, max_steps=230, extra_opt_steps=0, log_fn=None)
        after = mae()
        assert tr.buffer.count >= 2
        assert after < before * 0.7, (before, after)
    finally:
        stop.set()
        cam_thread.join(timeout=2)
        ds.source.close()
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# ROS
# ---------------------------------------------------------------------------

def test_ros_message_helpers_equal_isdf_tpu():
    rng = np.random.default_rng(3)
    for _ in range(10):
        q = _rand_quat(rng)
        np.testing.assert_array_equal(TR.quat_xyzw_to_R(q),
                                      JR.quat_xyzw_to_R(q))
        msg = _pose_msg(rng.normal(size=3), q)
        np.testing.assert_array_equal(TR.pose_msg_to_T(msg),
                                      JR.pose_msg_to_T(msg))
        np.testing.assert_array_equal(TR.pose_msg_to_T_WC(msg),
                                      JR.pose_msg_to_T_WC(msg))
    bgr = rng.integers(0, 255, (60, 96, 3), dtype=np.uint8)
    depth = rng.integers(0, 5000, (60, 96), dtype=np.uint16)
    for crop in (False, True):
        np.testing.assert_array_equal(
            TR.decode_image_msg(_img_msg(bgr), np.uint8, 3, crop),
            JR.decode_image_msg(_img_msg(bgr), np.uint8, 3, crop))
        msg = NS(rgb=_img_msg(bgr), depth=_img_msg(depth),
                 pose=_pose_msg(rng.normal(size=3), _rand_quat(rng)))
        a, b = TR.decode_frame_msg(msg, crop), JR.decode_frame_msg(msg, crop)
        for k in ("image", "depth", "T"):
            np.testing.assert_array_equal(a[k], b[k])


def test_compose_franka_frame_gates_and_resizes():
    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)
    depth = rng.integers(0, 5000, (30, 40), dtype=np.uint16)
    T = np.eye(4, dtype=np.float32)
    assert TR.compose_franka_frame(None, depth, T) is None
    assert TR.compose_franka_frame(bgr, None, T) is None
    assert TR.compose_franka_frame(bgr, depth, None) is None
    # growing by 2 (cv2's INTER_AREA replicates), shrinking by 2, and the
    # same size: equal to isdf_tpu's (cv2.resize)
    for wh in ((80, 60), (20, 15), (40, 30)):
        a = TR.compose_franka_frame(bgr, depth, T, size_wh=wh)
        b = JR.compose_franka_frame(bgr, depth, T, size_wh=wh)
        assert a["image"].shape == (wh[1], wh[0], 3)
        for k in ("image", "depth", "T"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_ros_frame_source_wiring(monkeypatch):
    stub = _StubRospy()
    wrapper = types.ModuleType("orb_slam3_ros_wrapper")
    wrapper_msg = types.ModuleType("orb_slam3_ros_wrapper.msg")
    wrapper_msg.frame = object
    wrapper.msg = wrapper_msg
    got, stop, th = _run_source(
        TR.ROSFrameSource(), stub, monkeypatch,
        [("orb_slam3_ros_wrapper", wrapper),
         ("orb_slam3_ros_wrapper.msg", wrapper_msg)])
    try:
        assert stub.inited == "isdf" and "/frames" in stub.subs
        rng = np.random.default_rng(5)
        bgr = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
        depth = rng.integers(0, 999, (12, 16), dtype=np.uint16)
        msg = NS(rgb=_img_msg(bgr), depth=_img_msg(depth),
                 pose=_pose_msg([0.0, 0.0, 0.0], [0, 0, 0, 1]))
        stub.subs["/frames"](msg)
        assert len(got) == 1
        assert np.array_equal(got[0]["image"], bgr[..., ::-1])
    finally:
        stop.set()
        th.join(timeout=2)
    assert not th.is_alive()


def test_ros_franka_source_wiring(monkeypatch):
    from scipy.spatial.transform import Rotation
    stub = _StubRospy()
    geom = types.ModuleType("geometry_msgs")
    geom_msg = types.ModuleType("geometry_msgs.msg")
    geom_msg.Pose = object
    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")
    sensor_msg.Image = object
    got, stop, th = _run_source(
        TR.ROSFrankaSource(CAL, size_wh=(16, 12)), stub, monkeypatch,
        [("geometry_msgs", geom), ("geometry_msgs.msg", geom_msg),
         ("sensor_msgs", sensor), ("sensor_msgs.msg", sensor_msg)])
    try:
        assert stub.inited == "isdf_franka"
        assert set(stub.subs) == {"/franka/rgb", "/franka/depth",
                                  "/franka/pose"}
        rng = np.random.default_rng(6)
        bgr = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
        depth = rng.integers(0, 999, (12, 16), dtype=np.uint16)
        stub.subs["/franka/rgb"](_img_msg(bgr))
        assert got == []
        stub.subs["/franka/depth"](_img_msg(depth))
        t, q = rng.normal(size=3), _rand_quat(rng)
        stub.subs["/franka/pose"](_pose_msg(t, q))
        stub.subs["/franka/rgb"](_img_msg(bgr))
        assert len(got) == 1
        assert np.array_equal(got[0]["image"], bgr[..., ::-1])
        T_ee = np.eye(4)
        T_ee[:3, :3] = Rotation.from_quat(q).as_matrix()
        T_ee[:3, 3] = t
        np.testing.assert_array_equal(got[0]["T"], JL.ee_to_cam(T_ee, CAL))
    finally:
        stop.set()
        th.join(timeout=2)
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# ARKit
# ---------------------------------------------------------------------------

def _arkit_msg(rng):
    from scipy.spatial.transform import Rotation
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = Rotation.from_euler("xyz", rng.uniform(-60, 60, 3),
                                    degrees=True).as_matrix()
    P[:3, 3] = rng.normal(size=3)
    depth = rng.uniform(0.5, 3.0, (TA.DEPTH_H, TA.DEPTH_W)).astype(
        np.float32)
    intr = np.array([212.0, 212.0, 128.0, 96.0], np.float32)
    return np.concatenate([P.T.reshape(-1), intr,
                           depth.reshape(-1)]).tobytes(), depth


def test_arkit_wire_format_equals_isdf_tpu(tmp_path):
    rng = np.random.default_rng(7)
    for _ in range(3):
        msg, depth = _arkit_msg(rng)
        a, b = TA.decode_depth_message(msg), JA.decode_depth_message(msg)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[0], depth)
    with pytest.raises(ValueError):
        TA.decode_depth_message(msg[:-8])
    # the colour message: the port's imdecode where isdf_tpu calls cv2's
    cv2 = pytest.importorskip("cv2")
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    a = TA.decode_rgb_message(buf.tobytes())
    d = np.abs(a.astype(int) - JA.decode_rgb_message(buf.tobytes()))
    assert a.shape == (48, 64, 3) and d.max() <= 4 and d.mean() <= 0.5
    ok, buf = cv2.imencode(".png", img)
    np.testing.assert_array_equal(TA.decode_rgb_message(buf.tobytes()),
                                  JA.decode_rgb_message(buf.tobytes()))

    # directory source -> live pipeline -> make_dataset("arkit")
    with open(tmp_path / ".tmp0.bin", "wb") as f:
        f.write(msg)
    os.replace(tmp_path / ".tmp0.bin", tmp_path / "frame0000.bin")
    from isdf_tpu_torch.data.datasets import make_dataset
    from isdf_tpu_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "dataset": {"format": "arkit", "live_dir": str(tmp_path),
                    "depth_scale": 1.0,
                    "camera": {"w": TA.DEPTH_W, "h": TA.DEPTH_H,
                               "fx": 212.0, "fy": 212.0,
                               "cx": 128.0, "cy": 96.0}},
        "sample": {"depth_range": [0.07, 12.0]}})
    ds = make_dataset(cfg)
    try:
        assert isinstance(ds, TL.LiveDataset)
        s = ds[0]
        np.testing.assert_array_equal(s["T"], JA.decode_depth_message(msg)[1])
    finally:
        ds.source.close()
    with pytest.raises(RuntimeError, match="pika"):
        TA.ARKitQueueSource()


def test_arkit_directory_source_retries_partial_files(tmp_path):
    msg, depth = _arkit_msg(np.random.default_rng(8))
    path = tmp_path / "frame0000.bin"
    with open(path, "wb") as f:
        f.write(msg[: len(msg) // 2])
    src = TA.ARKitDirectorySource(str(tmp_path), poll_s=0.01)
    got, stop = [], threading.Event()
    th = threading.Thread(target=src, args=(got.append, stop), daemon=True)
    th.start()
    try:
        time.sleep(0.1)
        assert got == []
        with open(path, "wb") as f:
            f.write(msg)
        t0 = time.time()
        while not got and time.time() - t0 < 5.0:
            time.sleep(0.02)
        assert got, "the completed file was never read again"
        np.testing.assert_array_equal(got[0]["depth"], depth)
    finally:
        stop.set()
        th.join(timeout=2.0)


# ---------------------------------------------------------------------------
# assets, the GT-SDF composer, trajectories
# ---------------------------------------------------------------------------

def test_glb_loader_equals_isdf_tpu(tmp_path):
    for i, tr in enumerate((None, (5.0, 0.0, -2.0))):
        p = str(tmp_path / f"tri{i}.glb")
        _write_glb(p, TRI_V, TRI_F, node_translation=tr)
        (v, f), (jv, jf) = TAS.load_glb(p), JAS.load_glb(p)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
    assert np.allclose(v, TRI_V + np.array([5.0, 0.0, -2.0]))


def test_urdf_fk_equals_isdf_tpu(tmp_path):
    from isdf_tpu_torch.utils.mesh3d import load_mesh
    _write_obj(tmp_path / "base.obj", TRI_V, TRI_F)
    _write_obj(tmp_path / "door.obj", TRI_V, TRI_F)
    urdf = tmp_path / "cab.urdf"
    urdf.write_text("""
<robot name="cab">
  <link name="base">
    <visual><geometry><mesh filename="base.obj"/></geometry></visual>
  </link>
  <link name="door">
    <visual><geometry><mesh filename="door.obj" scale="1 2 1"/></geometry>
    </visual>
  </link>
  <joint name="hinge" type="revolute">
    <parent link="base"/><child link="door"/>
    <origin xyz="1 0 0" rpy="0 0 0.3"/><axis xyz="0 0 1"/>
  </joint>
</robot>""")
    for cfg in (None, {"hinge": np.pi / 2}):
        got = TAS.load_urdf_meshes(str(urdf), load_mesh, joint_cfg=cfg)
        want = JAS.load_urdf_meshes(str(urdf), load_mesh, joint_cfg=cfg)
        assert len(got) == len(want) == 2
        for (v, f), (jv, jf) in zip(got, want):
            np.testing.assert_array_equal(v, jv)
            np.testing.assert_array_equal(f, jf)


def test_composer_equals_isdf_tpu(tmp_path):
    """GLB stage + URDF articulated object -> the gt_sdf directory, equal
    to isdf_tpu's composer's (tests/test_assets.py:120)."""
    import json

    from isdf_tpu.data.replicaCAD_gt_sdf import main as jmain
    from isdf_tpu_torch.data.replicaCAD_gt_sdf import main as tmain
    asset_root = tmp_path / "assets"
    (asset_root / "stages").mkdir(parents=True)
    (asset_root / "urdf" / "cab").mkdir(parents=True)
    b = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    bf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                   [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                   [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    _write_glb(str(asset_root / "stages" / "room.glb"), b, bf)
    _write_obj(asset_root / "urdf" / "cab" / "part.obj", b * 0.05, bf)
    (asset_root / "urdf" / "cab" / "cab.urdf").write_text("""
<robot name="cab"><link name="core">
  <visual><geometry><mesh filename="part.obj"/></geometry></visual>
</link></robot>""")
    scene = tmp_path / "scene.scene_instance.json"
    scene.write_text(json.dumps({
        "stage_instance": {"template_name": "room"},
        "object_instances": [],
        "articulated_object_instances": [
            {"template_name": "cab", "translation": [1.1, 0.0, 0.0]}]}))
    got = tmain(str(scene), str(asset_root), str(tmp_path / "t"), voxel=0.05)
    want = jmain(str(scene), str(asset_root), str(tmp_path / "j"),
                 voxel=0.05)
    for k in ("sdf", "stage_sdf", "transform"):
        np.testing.assert_array_equal(got[k], want[k])
    for name in ("sdf.npy", "stage_sdf.npy", "transform.txt"):
        assert (tmp_path / "t" / "1cm" / name).exists()
    assert (tmp_path / "t" / "mesh.ply").exists()
    T = got["transform"]
    c = np.round((np.array([1.1, 0, 0]) - T[:3, 3]) / T[0, 0]).astype(int)
    assert got["sdf"][tuple(c)] < got["stage_sdf"][tuple(c)]


@pytest.mark.parametrize("fmt", ["replica", "realsense_franka", "TUM"])
def test_save_trajectory_text_equals_isdf_tpu(tmp_path, fmt):
    from scipy.spatial.transform import Rotation

    from isdf_tpu.utils.trajectory import save_trajectory as jsave
    from isdf_tpu_torch.utils.trajectory import save_trajectory as tsave
    rng = np.random.default_rng(9)
    traj = np.tile(np.eye(4), (6, 1, 1))
    traj[:, :3, :3] = Rotation.from_rotvec(rng.normal(size=(6, 3))
                                           ).as_matrix()
    traj[:, :3, 3] = rng.normal(size=(6, 3))
    traj[0, :3, :3] = np.diag([1.0, -1.0, -1.0])   # trace < 0 branch
    for ts in (None, np.linspace(10.0, 11.0, 6)):
        tsave(traj, str(tmp_path / "t.txt"), format=fmt, timestamps=ts)
        jsave(traj, str(tmp_path / "j.txt"), format=fmt, timestamps=ts)
        assert (tmp_path / "t.txt").read_text() == \
            (tmp_path / "j.txt").read_text()
    with pytest.raises(ValueError):
        tsave(traj, str(tmp_path / "x.txt"), format="bogus")
