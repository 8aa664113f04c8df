"""The port's dataset layer against isdf_tpu's on the CPU, on fixtures
written in the real formats (tiny: 48x64 frames, 15 frames, hidden 32,
n_embed_funcs 3).

* The readers (ReplicaCAD, ScanNet, Franka offline) read isdf_tpu-written
  files to the same depth and pose (exact) and image (PNG exact, JPEG
  within max 4 / mean 0.5 levels), and isdf_tpu's readers read the port's
  files the same way.
* _write_eval_tree on the same read-back frames, grid and seed writes
  bit-equal masks and volume points.
* sdf_util: the interpolator and its out-of-bounds modes, the grid
  readers, mesh_to_sdf and get_colormap exact; trilinear_interp within
  1e-6 of trilinear_interp_jax.
* The Trainer on the fixtures: the scene frame from mesh.obj (rtol 1e-6),
  gt_sdf_fn (exact), ScanNet's camera and |grid| equal isdf_tpu's; the
  fixed-point eval on the same weights equals isdf_tpu's (rtol 1e-5); the
  CLI writes vox_res.json with the four regions.
* make_dataset builds the same reader for every shipped file config.
"""

import json
import os

import numpy as np
import pytest
import torch

from isdf_tpu.data import fixtures as JF
from isdf_tpu.data import sdf_util as JS
from isdf_tpu.data import datasets as JD
from isdf_tpu.utils.config import load_config as jload
from isdf_tpu_torch.data import datasets as TD
from isdf_tpu_torch.data import fixtures as TF
from isdf_tpu_torch.data import sdf_util as TS
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils.config import load_config as tload

from test_torch_eval_pts import MASKS, _assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_frames=15, H=48, W=64, grid_dim=32, mesh_dim=32,
            eval_times=(0.2, 0.4), eval_samples=4000, hidden_size=32,
            n_embed_funcs=3, n_rays=30)
FIXTURES = {}


@pytest.fixture
def cv2():
    """cv2, through which isdf_tpu writes its fixtures and reads frames:
    the tests that go through isdf_tpu's writer or readers take it and skip
    on a host without it; the others need no cv2."""
    return pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _fixture(kind, writer, tmp_path_factory):
    """A fixture config path, written once per module by ``writer``
    ("jax": isdf_tpu's, "torch": the port's)."""
    key = (kind, writer)
    if key not in FIXTURES:
        root = str(tmp_path_factory.mktemp(f"{kind}_{writer}"))
        mod = JF if writer == "jax" else TF
        fn = (mod.write_replicaCAD_fixture if kind == "replicaCAD"
              else mod.write_scannet_fixture)
        FIXTURES[key] = fn(root, **TINY)
    return FIXTURES[key]


def _readers(cfg_path, kind):
    jcfg, tcfg = jload(cfg_path), tload(cfg_path)
    if kind == "replicaCAD":
        return (JD.ReplicaDataset(jcfg.seq_dir, jcfg),
                TD.ReplicaDataset(tcfg.seq_dir, tcfg))
    return (JD.ScanNetDataset(jcfg.scannet_dir, jcfg),
            TD.ScanNetDataset(tcfg.scannet_dir, tcfg))


def _same_frames(jds, tds, jpeg):
    assert len(jds) == len(tds) == TINY["n_frames"]
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        np.testing.assert_array_equal(b["depth"], a["depth"])
        assert b["depth"].dtype == a["depth"].dtype == np.float32
        np.testing.assert_array_equal(b["T"], a["T"])
        if jpeg:
            d = np.abs(b["image"].astype(int) - a["image"])
            assert d.max() <= 4 and d.mean() <= 0.5
        else:
            np.testing.assert_array_equal(b["image"], a["image"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["replicaCAD", "ScanNet"])
def test_readers_agree_on_both_packages_fixtures(kind, writer, cv2,
                                                 tmp_path_factory):
    cfg = _fixture(kind, writer, tmp_path_factory)
    jds, tds = _readers(cfg, kind)
    _same_frames(jds, tds, jpeg=kind == "ScanNet")
    assert (tds[3]["depth"] > 0).mean() > 0.5   # the room is visible


def test_port_fixture_layout_and_config(cv2, tmp_path_factory):
    """The port writes isdf_tpu's layout and config: the same files, and
    the same config but for the paths."""
    for kind in ("replicaCAD", "ScanNet"):
        j = _fixture(kind, "jax", tmp_path_factory)
        t = _fixture(kind, "torch", tmp_path_factory)
        jroot, troot = os.path.dirname(j), os.path.dirname(t)
        files = [sorted(os.path.relpath(os.path.join(d, f), r)
                        for d, _, fs in os.walk(r) for f in fs)
                 for r in (jroot, troot)]
        assert files[0] == files[1]
        with open(j) as f:
            jd = json.dumps(json.load(f)).replace(jroot, "R")
        with open(t) as f:
            td = json.dumps(json.load(f)).replace(troot, "R")
        assert jd == td
        for name in ("transform.txt",):
            sub = os.path.join("gt_sdfs", "room_a" if kind == "replicaCAD"
                               else "scene_room_c", "1cm", name)
            np.testing.assert_allclose(
                np.loadtxt(os.path.join(troot, sub)),
                np.loadtxt(os.path.join(jroot, sub)), rtol=1e-6)


def _write_trees(kind, cfg_path, out, jax_side):
    """One package's _write_eval_tree over frames read back from cfg_path,
    its scene, the fixture's grid and seed 0."""
    jcfg = jload(cfg_path)
    gt_dir = jcfg.gt_sdf_dir
    grid = np.load(os.path.join(gt_dir, "1cm", "sdf.npy"))
    transform = np.loadtxt(os.path.join(gt_dir, "1cm", "transform.txt"))
    preset = "room_a" if kind == "replicaCAD" else "room_c"
    if jax_side:
        from isdf_tpu.data.synthetic import make_scene
        mod, ds = JF, _readers(cfg_path, kind)[0]
    else:
        from isdf_tpu_torch.data.synthetic import make_scene
        mod, ds = TF, _readers(cfg_path, kind)[1]
    scene = make_scene(preset)
    scannet = kind == "ScanNet"
    if scannet:
        from isdf_tpu.utils.config import scannet_cam_params
        cam = scannet_cam_params(jcfg.intrinsics_file)
    else:
        cam = jcfg.camera
    from isdf_tpu_torch.ops.geometry import ray_dirs_C
    dirs = ray_dirs_C(TINY["H"], TINY["W"], cam.fx, cam.fy, cam.cx,
                      cam.cy).numpy()
    masks, vol = os.path.join(out, "masks"), os.path.join(out, "vol")
    os.makedirs(masks)
    os.makedirs(vol)
    mod._write_eval_tree(
        masks, vol, ds, scene, mod._grid_fn(grid, transform,
                                            absolute=scannet),
        dirs_C=dirs, fps=30.0, n_frames=TINY["n_frames"],
        eval_times=TINY["eval_times"], eval_samples=TINY["eval_samples"],
        vox_shrink=0.85, dist_behind=0.0 if scannet else 0.1,
        vol_name="v", seq="s", rng=np.random.default_rng(0),
        gt_vol_fn=(lambda p: np.abs(scene.sdf_np(p))) if scannet else None)
    return masks, vol


@pytest.mark.parametrize("kind", ["replicaCAD", "ScanNet"])
def test_write_eval_tree_bit_equal(kind, cv2, tmp_path, tmp_path_factory):
    cfg = _fixture(kind, "jax", tmp_path_factory)
    jm, jv = _write_trees(kind, cfg, str(tmp_path / "j"), True)
    tm, tv = _write_trees(kind, cfg, str(tmp_path / "t"), False)
    for t in TINY["eval_times"]:
        for name in MASKS:
            f = os.path.join(f"{t:.3f}", name + ".npy")
            a, b = np.load(os.path.join(jm, f)), np.load(os.path.join(tm, f))
            assert a.dtype == b.dtype == bool and a.any()
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(np.load(os.path.join(tv, "v.npy")),
                                  np.load(os.path.join(jv, "v.npy")))
    np.testing.assert_allclose(np.load(os.path.join(tv, "gt_s.npy")),
                               np.load(os.path.join(jv, "gt_s.npy")),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# sdf_util
# ---------------------------------------------------------------------------

def _grid(seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((20, 17, 13)).astype(np.float32)
    tr = np.eye(4, dtype=np.float32)
    tr[0, 0], tr[1, 1], tr[2, 2] = 0.1, 0.12, 0.09
    tr[:3, 3] = [-1.0, -0.5, 0.2]
    return g, tr, rng.uniform(-1.5, 2.5, (3000, 3)).astype(np.float32)


def test_interpolator_and_oob_modes_exact():
    g, tr, pts = _grid()
    ji, ti = JS.sdf_interpolator(g, tr), TS.sdf_interpolator(g, tr)
    inside = pts[np.all((pts >= [-1, -0.5, 0.2])
                        & (pts <= [0.9, 1.42, 1.28]), -1)]
    np.testing.assert_array_equal(TS.eval_sdf_interp(ti, inside),
                                  JS.eval_sdf_interp(ji, inside))
    for mode, val in (("fill", np.nan), ("fill", 0.0), ("mask", 0.0)):
        a = JS.eval_sdf_interp(ji, pts, handle_oob=mode, oob_val=val)
        b = TS.eval_sdf_interp(ti, pts, handle_oob=mode, oob_val=val)
        if mode == "mask":
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
        else:
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        TS.eval_sdf_interp(ti, pts, handle_oob="except")
    with pytest.raises(ValueError):
        TS.eval_sdf_interp(ti, pts, handle_oob="bogus")


def test_trilinear_interp_matches_jax():
    g, tr, pts = _grid(1)
    want = np.asarray(JS.trilinear_interp_jax(g, tr)(pts))
    got = TS.trilinear_interp(g, tr, device="cpu")(torch.from_numpy(pts))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_grid_readers_and_merge(tmp_path):
    g, tr, _ = _grid(2)
    np.save(tmp_path / "g.npy", g)
    g.tofile(tmp_path / "g.bin")
    with open(tmp_path / "g.txt", "w") as f:
        f.write(" ".join(str(d) for d in g.shape) + "\n")
        np.savetxt(f, g.reshape(-1))
    np.savetxt(tmp_path / "t.txt", tr)
    np.savetxt(tmp_path / "fus.txt", g.reshape(-1))
    with open(tmp_path / "fus_tr.txt", "w") as f:
        f.write("dims " + " ".join(map(str, g.shape)) + "\n"
                "voxel_size 0.1 0.12 0.09\noffset -1.0 -0.5 0.2\n")
    for fn, args in ((TS.read_sdf_npy, (str(tmp_path / "g.npy"),)),
                     (TS.read_sdf_binary, (str(tmp_path / "g.bin"),
                                           g.shape)),
                     (TS.read_sdf_habitat_txt, (str(tmp_path / "g.txt"),)),
                     (TS.load_transform_txt, (str(tmp_path / "t.txt"),))):
        np.testing.assert_array_equal(fn(*args),
                                      getattr(JS, fn.__name__)(*args))
    a = TS.read_sdf_gpufusion(str(tmp_path / "fus.txt"),
                              str(tmp_path / "fus_tr.txt"))
    b = JS.read_sdf_gpufusion(str(tmp_path / "fus.txt"),
                              str(tmp_path / "fus_tr.txt"))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    grids = [g, g[::-1].copy(), -g]
    np.testing.assert_array_equal(TS.merge_sdfs(grids), JS.merge_sdfs(grids))


def test_mesh_to_sdf_matches_jax():
    from isdf_tpu_torch.data.synthetic import SyntheticScene
    from isdf_tpu_torch.utils import mesh3d
    box = SyntheticScene(extents=(1.0, 0.8, 0.6), spheres=[], boxes=[])
    dim = 24
    axes = [np.linspace(-0.7, 0.7, dim, dtype=np.float32)] * 3
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    sdf = -box.sdf_np(pts).reshape(dim, dim, dim)   # a closed box surface
    v_idx, faces = mesh3d.marching_tetrahedra(sdf, level=0.0)
    verts = (-0.7 + v_idx * (1.4 / (dim - 1))).astype(np.float32)
    tr = np.eye(4)
    tr[:3, :3] *= 0.1
    tr[:3, 3] = -0.8
    dims = (17, 17, 17)
    got = TS.mesh_to_sdf(verts, faces, dims, tr)
    want = JS.mesh_to_sdf(verts, faces, dims, tr)
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got > 0).any()
    np.testing.assert_array_equal(
        TS.mesh_to_occupancy(verts, faces, dims, tr),
        JS.mesh_to_occupancy(verts, faces, dims, tr))


@pytest.mark.parametrize("rng_range,alpha,as_bytes",
                         [((-2.0, 2.0), 1.0, False), ((-1.0, 0.5), 0.4, True)])
def test_get_colormap_matches_jax(rng_range, alpha, as_bytes):
    v = np.concatenate([np.linspace(-3, 3, 1201),
                        [np.nan, 0.005, -0.005, 2.0, -2.0, 1e9, -np.inf,
                         np.inf]])
    for vals in (v, v.astype(np.float32).reshape(-1, 1)):
        got = TS.get_colormap(rng_range).to_rgba(vals, alpha=alpha,
                                                 bytes=as_bytes)
        want = JS.get_colormap(rng_range).to_rgba(vals, alpha=alpha,
                                                  bytes=as_bytes)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the trainer on the fixtures
# ---------------------------------------------------------------------------

def _trainers(cfg_path):
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
    jt = JTrainer(jload(cfg_path), seed=1, grid_dim=8)
    tt = TTrainer(tload(cfg_path), seed=1, grid_dim=8, device="cpu")
    return jt, tt


@pytest.mark.parametrize("kind", ["replicaCAD", "ScanNet"])
def test_trainer_scene_frame_gt_and_fixed_eval(kind, cv2,
                                               tmp_path_factory):
    cfg = _fixture(kind, "jax", tmp_path_factory)
    jt, tt = _trainers(cfg)
    assert tt.gt_scene and jt.gt_scene
    np.testing.assert_allclose(tt.bounds_transform_np,
                               jt.bounds_transform_np, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tt.scene_extents_np, jt.scene_extents_np,
                               rtol=1e-6)
    np.testing.assert_allclose(tt.scene_center, jt.scene_center, rtol=1e-6)
    assert (tt.H, tt.W, tt.fx, tt.fy, tt.cx, tt.cy) == (
        jt.H, jt.W, jt.fx, jt.fy, jt.cx, jt.cy)
    assert tt.eval_times == jt.eval_times == list(TINY["eval_times"])
    pts = np.random.default_rng(0).uniform(-4, 4, (4000, 3)).astype(
        np.float32)
    gt = tt.gt_sdf_fn(pts)
    np.testing.assert_array_equal(gt, jt.gt_sdf_fn(pts))
    assert np.isnan(gt).any() and np.isfinite(gt).any()
    if kind == "ScanNet":
        # the camera of the scene info txt; |grid| as GT
        assert (tt.H, tt.W) == (TINY["H"], TINY["W"])
        assert np.nanmin(gt) >= 0.0
    # the fixed-point protocol on the same weights and frames
    for tr in (jt, tt):
        for fid in (0, 6, 12):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
    tt.run_steps(20)
    jt.params = TM.params_to_jax(tt.params, tt.model)
    t = TINY["eval_times"][-1]
    got, want = tt.eval_fixed(t), jt.eval_fixed(t)
    regions = {"rays", "visible_surf", "vol"} | (
        {"objects"} if kind == "replicaCAD" else set())
    assert regions <= set(got)
    _assert_close(got, want)


def test_cli_on_port_fixture_writes_vox_res(tmp_path, tmp_path_factory):
    from isdf_tpu_torch.train.train import main
    cfg = _fixture("replicaCAD", "torch", tmp_path_factory)
    out = str(tmp_path / "run")
    res = main(["--config", cfg, "--device", "cpu", "--save_path", out,
                "--max_steps", "45", "--sim_dt", "0.01",
                "--set", "tpu.kf_buffer_size=16"])
    assert res.steps == 45
    with open(os.path.join(out, "vox_res.json")) as f:
        vox = json.load(f)
    assert sorted(vox, key=float) == ["0.2", "0.4"]
    for entry in vox.values():
        assert {"rays", "visible_surf", "vol", "objects"} <= set(entry)
        for split in ("vis", "vox"):
            assert np.isfinite(entry["rays"][split]["av_l1"])
            assert np.isfinite(entry["visible_surf"][split]["av_l1"])
        assert np.isfinite(entry["vol"]["av_l1"])
        assert len(entry["objects"]["l1"]) == 4


def test_make_dataset_for_every_file_format(cv2, tmp_path,
                                            tmp_path_factory):
    """Each shipped file config, pointed at fixture data, builds the same
    reader in both packages with the same frames."""
    rc = jload(_fixture("replicaCAD", "jax", tmp_path_factory))
    sn = jload(_fixture("ScanNet", "jax", tmp_path_factory))
    rec = str(tmp_path / "rec")
    os.makedirs(rec)
    rows = []
    for i in range(3):
        s = JD.ReplicaDataset(rc.seq_dir, rc)[i]
        np.save(os.path.join(rec, f"depth{i:06d}.npy"),
                (s["depth"] * 1000.0).astype(np.float32))
        cv2.imwrite(os.path.join(rec, f"frame{i:06d}.jpg"),
                    s["image"][..., ::-1])
        rows.append(np.concatenate([[100.0 + i], s["T"].reshape(16)]))
    np.savetxt(os.path.join(rec, "traj.txt"), np.stack(rows))
    cases = {"replicaCAD.json": {"dataset": {"seq_dir": rc.seq_dir}},
             "scannet.json": {"dataset": {"scannet_dir": sn.scannet_dir,
                                          "intrinsics_file":
                                              sn.intrinsics_file}},
             "realsense_franka_offline.json": {"dataset": {"seq_dir": rec}}}
    for name, over in cases.items():
        sets = [f"dataset.{k}={v}" for k, v in over["dataset"].items()]
        jc = jload(os.path.join(ROOT, "isdf_tpu", "train", "configs", name),
                   sets)
        tc = tload(os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                                name), sets)
        jds, tds = JD.make_dataset(jc), TD.make_dataset(tc)
        assert type(tds).__name__ == type(jds).__name__
        assert len(tds) == len(jds)
        for i in (0, len(jds) - 1):
            np.testing.assert_array_equal(tds[i]["depth"], jds[i]["depth"])
            np.testing.assert_array_equal(tds[i]["T"], jds[i]["T"])
            d = np.abs(tds[i]["image"].astype(int) - jds[i]["image"])
            assert d.max() <= 4 and d.mean() <= 0.5
    # replica: the same layout with .jpg colour
    cfg = _fixture("replicaCAD", "jax", tmp_path_factory)
    jds = JD.make_dataset(jload(cfg).replace(dataset_format="replica"))
    tds = TD.make_dataset(tload(cfg).replace(dataset_format="replica"))
    assert isinstance(tds, TD.ReplicaDataset)
    assert tds.col_ext == jds.col_ext == ".jpg"
