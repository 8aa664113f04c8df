"""The port's live monitor and train_vis (vis/views.py, vis/viewer.py,
train/train_vis.py) against isdf_tpu's on the CPU.

* latest_frame_vis on the same weights: the rgb and GT-depth quadrants
  exactly; the rendered depth (on isdf_tpu's own stratified draws) within
  1e-5 and the depth and normals quadrants within one level.
* SDFPointcloudViewer's slabs, save_level_sets' limits, points and
  colours, save_traj_seq's camera angles: equal to isdf_tpu's.
* train_vis on the CPU writes isdf_tpu's file names; with --serve it
  serves the viewer while it runs, and the viewer's pause freezes its
  steps and sim clock.
* The monitor leaves the training bit for bit as it was: the parameters
  after train_vis equal those of the same run under train_loop with a
  hook that draws nothing.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.vis import viewer as JV
from isdf_tpu.vis import views as JVW
from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.vis import viewer as TV
from isdf_tpu_torch.vis import views as TVW
from tests.test_torch_vis_draw import uv_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = (64, 48, 40.0, 40.0, 31.5, 23.5)
GRID_DIM = 40


def _cfg(cls, **kw):
    cam = cls().camera.__class__(*CAM)
    base = dict(dataset_format="synthetic", n_rays=20, n_strat_samples=9,
                n_surf_samples=4, hidden_feature_size=64,
                hidden_layers_block=1, n_embed_funcs=4, kf_buffer_size=12,
                iters_per_frame=10, iters_per_kf=30, bounds_method="pc",
                do_eval=False, mm_precision="highest", camera=cam)
    base.update(kw)
    return cls().replace(**base)


@pytest.fixture(scope="module")
def pair():
    """A port trainer trained 40 steps on three frames, and an isdf_tpu
    trainer on the same scene with its weights and frames."""
    from isdf_tpu.data.synthetic import SyntheticDataset as JDS
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.utils.config import Config as JConfig
    from isdf_tpu_torch.data.synthetic import (SyntheticDataset,
                                               SyntheticScene)
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import sdf_mlp as TM
    from isdf_tpu_torch.utils.config import Config

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        tt = Trainer(_cfg(Config), dataset=SyntheticDataset(
            SyntheticScene(), n_frames=60, H=48, W=64), seed=1,
            device="cpu", grid_dim=GRID_DIM)
        jt = JTrainer(_cfg(JConfig), dataset=JDS(
            JScene(), n_frames=60, H=48, W=64), seed=1, grid_dim=GRID_DIM)
        for tr in (tt, jt):
            for fid in (0, 20, 40):
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
        tt.run_steps(40)
        jt.params = jax.tree_util.tree_map(
            jnp.asarray, TM.params_to_jax(tt.params, tt.model))
        yield tt, jt
    finally:
        torch.set_num_threads(threads)


def test_latest_frame_vis_equals_isdf_tpus(pair):
    tt, jt = pair
    rf, n_strat = 8, 40
    H, W = tt.H // rf, tt.W // rf
    want = JVW.latest_frame_vis(jt, rf, n_strat)
    # isdf_tpu's draws from PRNGKey(0), as its sampler splits the key
    u = jax.random.uniform(jax.random.split(jax.random.PRNGKey(0))[0],
                           (H * W, n_strat))
    draws = torch.as_tensor(np.array(u))
    got = TVW.latest_frame_vis(tt, rf, n_strat, draws=draws)
    assert got.shape == want.shape == (2 * H, 2 * W, 3)
    np.testing.assert_array_equal(got[:H], want[:H])   # rgb, GT depth
    d = np.abs(got[H:].astype(int) - want[H:])
    assert d.max() <= 1, d.max()                       # normals, depth

    # the rendered depth itself, and the draws' independence from the
    # trainer's generator
    state = tt.fns.gen.get_state().clone() if hasattr(tt.fns, "gen") \
        else None
    rd, normals, _ = TVW.render_latest(tt, rf, n_strat, draws=draws)
    from isdf_tpu.ops import geometry as JG
    f = jt.frames[-1]
    ds = f.depth[::rf, ::rf][:H, :W]
    jd = jt.fns.render_depth(
        jt.params, jnp.asarray(f.T_WC)[None],
        JG.ray_dirs_C(H, W, jt.fx / rf, jt.fy / rf, jt.cx / rf,
                      jt.cy / rf).reshape(1, -1, 3),
        jnp.asarray(np.where(ds > 0, ds, 3.0).reshape(1, -1)),
        jt.transform_dev, jax.random.PRNGKey(0), n_strat=n_strat)
    np.testing.assert_allclose(rd, np.asarray(jd).reshape(H, W), atol=1e-5)
    assert np.isfinite(normals).all() and (rd > 0).any()
    if state is not None:
        assert torch.equal(state, tt.fns.gen.get_state())
    # without draws: a generator of its own, seeded 0 each call
    a = TVW.latest_frame_vis(tt, rf, n_strat)
    np.testing.assert_array_equal(a, TVW.latest_frame_vis(tt, rf, n_strat))


def test_monitor_files_and_text(pair, tmp_path):
    tt, _ = pair
    tt.step_timer.add("train", 0.5, 40)
    times = {}
    TV.monitor(tt, str(tmp_path), tag="0003_", times=times)
    strip = IO.imread(str(tmp_path / "0003_keyframes.png"))[..., ::-1]
    np.testing.assert_array_equal(strip, TVW.keyframe_strip(tt))
    latest = IO.imread(str(tmp_path / "0003_latest.png"))[..., ::-1]
    plain = TVW.latest_frame_vis(tt)
    assert latest.shape == plain.shape
    # the balance text is drawn in yellow on the panel's top rows
    changed = (latest != plain).any(-1)
    assert changed[:24].any() and not changed[24:].any()
    assert set(times) == {"latest", "write"}


def test_pointcloud_viewer_slabs_equal_isdf_tpus(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    pc = np.concatenate([rng.uniform(-1, 1, (500, 3)),
                         rng.uniform(-0.3, 0.4, (500, 1))], 1)
    pc[:100, 2] = np.round(pc[:100, 2], 1)
    for kw in (dict(max_slabs=12), dict(max_slabs=2000),
               dict(max_slabs=7, sdf_range=(-0.5, 0.5))):
        a, b = TV.SDFPointcloudViewer(pc, **kw), JV.SDFPointcloudViewer(pc,
                                                                       **kw)
        np.testing.assert_array_equal(a.pc, b.pc)
        np.testing.assert_array_equal(a.zs, b.zs)
        assert a.sdf_range == b.sdf_range and a.idx == b.idx
    # each slab's points and colours, as isdf_tpu selects them
    seen = {}
    for mod, key in ((TV, "t"), (JV, "j")):
        seen[key] = []
        _recorder(mod, "render_pointcloud_image", monkeypatch, seen[key])
        viewer = mod.SDFPointcloudViewer(pc, max_slabs=9)
        for i in range(len(viewer.zs)):
            viewer._slab_img(i)
    assert len(seen["t"]) == len(seen["j"]) == 9
    for (at, kt), (aj, kj) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(at[0], aj[0])
        np.testing.assert_array_equal(at[1], aj[1])
        np.testing.assert_array_equal(kt["bounds"], kj["bounds"])
    monkeypatch.undo()
    v = TV.SDFPointcloudViewer(pc, max_slabs=5)
    v.save(str(tmp_path), stride=2)
    assert sorted(os.listdir(tmp_path)) == [f"slab_{i:04d}.png"
                                            for i in (0, 2, 4)]
    # show() serves the viewer's own images over HTTP (vis/server.py)
    import json
    for viewer, n in ((v, 5), (TV.SDFSliceViewer(np.zeros((4, 4, 4))), 4)):
        web = viewer.show(port=0, block=False)
        try:
            assert json.loads(_http(web.port, "/api/meta")[1])[
                "n_slices"] == n
        finally:
            web.stop()


def _recorder(mod, name, monkeypatch, out):
    def rec(*a, **kw):
        out.append((a, kw))
        return np.zeros((4, 4, 3), np.uint8)
    monkeypatch.setattr(mod, name, rec)


def test_level_sets_and_traj_seq_equal_isdf_tpus(tmp_path, monkeypatch):
    import isdf_tpu.vis.mesh_export as JME
    import isdf_tpu_torch.vis.mesh_export as TME
    rng = np.random.default_rng(2)
    grid = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    sdf = (np.linalg.norm(grid, axis=1) - 0.6).astype(np.float32)

    def fake(pts_dev):
        return types.SimpleNamespace(
            grid_pc=pts_dev, sdf_fn=lambda p: sdf.copy(),
            frames=types.SimpleNamespace(T_WC_batch_np=lambda: poses))

    poses = np.tile(np.eye(4), (5, 1, 1))
    for i in range(5):
        a = 0.7 * i - 1.2
        poses[i, :3, 2] = [np.cos(a) * 0.8, np.sin(a) * 0.8, -0.6 + 0.3 * i]
    poses[:, :3, 2] /= np.linalg.norm(poses[:, :3, 2], axis=1)[:, None]
    seen_j, seen_t = [], []
    _recorder(JV, "render_pointcloud_image", monkeypatch, seen_j)
    _recorder(TV, "render_pointcloud_image", monkeypatch, seen_t)
    JV.save_level_sets(fake(grid), str(tmp_path / "j"), max_points=400)
    TV.save_level_sets(fake(torch.as_tensor(grid)), str(tmp_path / "t"),
                       max_points=400)
    assert len(seen_j) == len(seen_t) == 12
    for (aj, kj), (at, kt) in zip(seen_j, seen_t):
        np.testing.assert_array_equal(at[0], aj[0])          # points
        np.testing.assert_array_equal(at[1], aj[1])          # colours
        np.testing.assert_array_equal(kt["bounds"], kj["bounds"])
        assert kt["azim"] == kj["azim"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))

    mesh = (np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]))
    monkeypatch.setattr(JME, "reconstruct_mesh", lambda tr: mesh)
    monkeypatch.setattr(TME, "reconstruct_mesh", lambda tr: mesh)
    seen_j, seen_t = [], []
    _recorder(JV, "render_mesh_image", monkeypatch, seen_j)
    _recorder(TV, "render_mesh_image", monkeypatch, seen_t)
    JV.save_traj_seq(fake(grid), str(tmp_path / "js"))
    TV.save_traj_seq(fake(grid), str(tmp_path / "ts"))
    assert [s[1] for s in seen_t] == [s[1] for s in seen_j]   # azim, elev
    assert len(seen_t) == 5
    assert sorted(os.listdir(tmp_path / "ts")) == sorted(
        os.listdir(tmp_path / "js"))


# ---------------------------------------------------------------- train_vis

SETS = ("dataset.camera.w=32", "dataset.camera.h=24", "dataset.camera.fx=20",
        "dataset.camera.fy=20", "dataset.camera.cx=15.5",
        "dataset.camera.cy=11.5", "sample.n_rays=8",
        "model.hidden_feature_size=64", "tpu.kf_buffer_size=8",
        "eval.eval_freq_s=0.01", "tpu.steps_per_bundle=10")
STEPS = 20


def _args(pkg, save_path, *extra, steps=STEPS):
    cfg = os.path.join(ROOT, pkg, "train", "configs", "synthetic.json")
    args = ["--config", cfg, "--max_steps", str(steps), "--monitor_every_s",
            "0.02", "--save_path", str(save_path), *extra]
    for s in SETS:
        args += ["--set", s]
    return args


def _pin(monkeypatch, loop_mod, grid, seen=None):
    """train_loop wrapped: the trainer's clock pinned at 0.004 s a step
    and its meshing grid cut to ``grid`` before the loop runs."""
    orig = loop_mod.train_loop

    def spy(trainer, **kw):
        trainer._per_step_device_s = 0.004
        trainer.grid_dim = grid
        if isinstance(getattr(type(trainer), "grid_pc", None), property):
            trainer._grid_pc = None
        else:
            from isdf_tpu.ops import geometry as JG
            trainer.grid_pc = JG.make_3D_grid(
                (-1.0, 1.0), grid,
                transform=jnp.asarray(trainer.bounds_transform_np),
                scale=jnp.asarray(trainer.scene_scale_np)).reshape(-1, 3)
        if seen is not None:
            seen.append(trainer)
        return orig(trainer, **kw)

    monkeypatch.setattr(loop_mod, "train_loop", spy)


def _names(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_train_vis_writes_isdf_tpus_files(tmp_path, monkeypatch):
    import isdf_tpu.engine.loop as JL
    import isdf_tpu_torch.engine.loop as TL
    from isdf_tpu.train import train_vis as JTV
    from isdf_tpu_torch.train import train_vis as TTV

    _pin(monkeypatch, JL, 24)
    _pin(monkeypatch, TL, 24)
    # one small mesh for both turntables: the two runs' maps differ (their
    # random streams differ), and so may whether the grid holds a surface
    import isdf_tpu.vis.mesh_export as JME
    import isdf_tpu_torch.vis.mesh_export as TME
    v, f = uv_sphere()
    monkeypatch.setattr(JME, "reconstruct_mesh", lambda tr: (v, f))
    monkeypatch.setattr(TME, "reconstruct_mesh", lambda tr: (v, f))
    JTV.main(_args("isdf_tpu", tmp_path / "j"))
    res = TTV.main(_args("isdf_tpu_torch", tmp_path / "t", "--device",
                         "cpu", "--trace", str(tmp_path / "trace")))
    assert res.steps == STEPS
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    mine, theirs = _names(tmp_path / "t"), _names(tmp_path / "j")
    assert mine == theirs
    assert "monitor/0000_latest.png" in mine
    assert "monitor/final_mesh/view_07.png" in mine
    for name in mine:
        if name.endswith(".png"):
            assert IO.imread(str(tmp_path / "t" / name)).size > 0


def _http(port, path, body=None):
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_train_vis_serves_while_it_runs(tmp_path, monkeypatch):
    """train_vis --serve: the viewer answers during the run (status, a
    slice), a pause over HTTP freezes the steps and the sim clock, the run
    resumes and finishes, and the monitor writes its files as without
    the viewer."""
    import functools
    import json
    import threading
    import time

    import isdf_tpu_torch.engine.loop as TL
    import isdf_tpu_torch.engine.trainer as TT
    from isdf_tpu_torch.train import train_vis as TTV
    from isdf_tpu_torch.vis import server as TSV

    _pin(monkeypatch, TL, 16)
    # the viewer snapshots the grid before the loop starts: a small one
    monkeypatch.setattr(TT, "Trainer", functools.partial(TT.Trainer,
                                                         grid_dim=16))
    webs, start = [], TSV.SDFWebViewer.start

    def record(self):
        webs.append(self)
        return start(self)

    monkeypatch.setattr(TSV.SDFWebViewer, "start", record)
    out = {}
    th = threading.Thread(target=lambda: out.update(res=TTV.main(_args(
        "isdf_tpu_torch", tmp_path / "s", "--device", "cpu", "--serve", "0",
        steps=200))), daemon=True)
    th.start()
    t0 = time.time()
    while not webs and time.time() - t0 < 120:
        time.sleep(0.01)
    (web,) = webs
    port = web.port
    status = {}
    while time.time() - t0 < 120:
        status = json.loads(_http(port, "/api/status")[1])
        if status["steps"] > 0:
            break
        time.sleep(0.01)
    code, body = _http(port, "/api/slice/8.png")
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    assert status["live"] is True and 0 < status["steps"] < 200
    _http(port, "/api/control", json.dumps({"paused": True}).encode())
    time.sleep(1.0)   # the loop reaches its control hook
    a = json.loads(_http(port, "/api/status")[1])
    time.sleep(0.5)
    b = json.loads(_http(port, "/api/status")[1])
    assert a["paused"] is True and a["steps"] < 200
    assert (a["steps"], a["sim_time_s"]) == (b["steps"], b["sim_time_s"])
    _http(port, "/api/control", json.dumps({"paused": False}).encode())
    th.join(timeout=600)
    assert not th.is_alive() and out["res"].steps == 200
    names = _names(tmp_path / "s")
    n = sum(x.endswith("_latest.png") for x in names)
    assert n >= 2
    assert set(names) >= {f"monitor/{i:04d}_{k}.png" for i in range(n)
                          for k in ("keyframes", "latest", "pred_0",
                                    "pred_1")}
    assert "monitor/final_mesh/view_07.png" in names


def test_monitor_leaves_the_training_bits(tmp_path, monkeypatch):
    import isdf_tpu_torch.engine.loop as TL
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.train import train_vis as TTV
    from isdf_tpu_torch.utils.config import load_config

    seen = []
    _pin(monkeypatch, TL, 16, seen)
    # bundles of 10 steps, a monitor cycle after each
    TTV.main(_args("isdf_tpu_torch", tmp_path / "m", "--device", "cpu",
                   steps=60))
    cycles = [n for n in os.listdir(tmp_path / "m" / "monitor")
              if n.endswith("_latest.png")]
    assert len(cycles) >= 4
    monkeypatch.undo()

    cfg = load_config(os.path.join(ROOT, "isdf_tpu_torch", "train",
                                   "configs", "synthetic.json"),
                      overrides=list(SETS))
    plain = Trainer(cfg, seed=1, device="cpu", grid_dim=16)
    os.makedirs(tmp_path / "p")
    plain._per_step_device_s = 0.004
    res = TL.train_loop(plain, max_steps=60, eval_hook=lambda tr: {},
                        save_path=str(tmp_path / "p"))
    assert res.steps == 60
    (watched,) = seen
    for k in plain.params:
        assert torch.equal(plain.params[k], watched.params[k]), k
    assert watched.tot_step_time == plain.tot_step_time
