"""The port's meshing against isdf_tpu's on the CPU.

* Marching tetrahedra: the native library (both packages build the same
  C++ source) and the numpy path give isdf_tpu's vertices and faces on
  the same grid, exactly.
* The mesh3d helpers (weld, orientation, surface sampling, cropping, the
  PLY and OBJ readers and writers), pc_bounds, oriented_bounds and the
  synthetic scene's GT mesh equal isdf_tpu's (the same numpy code on the
  same inputs: exact, or float64 round-off 1e-12 for the PCA box).
* get_sdf_grid_sparse equals isdf_tpu's on the same weights (rtol 1e-5,
  atol 1e-6: two MLPs' float32 round-off), evaluates the same share of
  points, and its mesh equals the dense grid's.
* eval_mesh equals isdf_tpu's at the same seed: accuracy and completion
  within rtol 1e-4 (the meshes' vertices differ by the grids' round-off,
  which moves the sampled points by about 1e-6 m).
* The loop writes meshes (and checkpoints) at its save marks and
  "mesh_eval" entries into res.json.
"""

import json
import os

import numpy as np
import pytest
import torch

from isdf_tpu.data.synthetic import SyntheticDataset as JDataset
from isdf_tpu.data.synthetic import SyntheticScene as JScene
from isdf_tpu.ops import geometry as JG
from isdf_tpu.utils import mesh3d as JM
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.data.synthetic import SyntheticDataset as TDataset
from isdf_tpu_torch.data.synthetic import SyntheticScene as TScene
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import geometry as TG
from isdf_tpu_torch.utils import mesh3d as TMESH
from isdf_tpu_torch.utils import native
from isdf_tpu_torch.utils.config import Config as TConfig

from test_torch_slice import _small


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _grid(dim=40, seed=0):
    """A sphere SDF with smooth seeded noise (several surface pieces)."""
    ax = np.linspace(-1.5, 1.5, dim, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    rng = np.random.default_rng(seed)
    a = rng.normal(size=3).astype(np.float32)
    sdf = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 1.0
           + 0.15 * np.sin(2.0 * a[0] * gx + a[1] * gy) * np.cos(a[2] * gz))
    return sdf.astype(np.float32), (3.0 / (dim - 1),) * 3, (-1.5,) * 3


@pytest.mark.parametrize("native_path", [True, False])
def test_marching_tets_matches_jax(native_path):
    sdf, spacing, origin = _grid()
    if native_path:
        assert native.load("marching_tets") is not None, "g++ build failed"
        n0 = native.CALLS["marching_tets"]
    got = TMESH.marching_tetrahedra(sdf, 0.0, spacing, origin,
                                    prefer_native=native_path)
    want = JM.marching_tetrahedra(sdf, 0.0, spacing, origin,
                                  prefer_native=native_path)
    if native_path:
        assert native.CALLS["marching_tets"] == n0 + 1
    assert len(got[1]) > 1000
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # an empty level set
    v, f = TMESH.marching_tetrahedra(np.ones((6, 6, 6), np.float32),
                                     prefer_native=native_path)
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_native_and_numpy_meshes_agree():
    """The two paths extract one surface: the same vertex and face counts
    and the same vertices to 1e-4 (2e-3 of the 0.077 grid spacing; the
    paths interpolate an edge from either end)."""
    sdf, spacing, origin = _grid(seed=1)
    vn, fn = TMESH.marching_tetrahedra(sdf, 0.0, spacing, origin)
    vp, fp = TMESH.marching_tetrahedra(sdf, 0.0, spacing, origin,
                                       prefer_native=False)
    assert len(fn) == len(fp) and len(vn) == len(vp)
    np.testing.assert_allclose(np.sort(vn, axis=0), np.sort(vp, axis=0),
                               atol=1e-4)


def test_mesh_helpers_match_jax(tmp_path):
    sdf, spacing, origin = _grid(seed=2)
    v, f = JM.marching_tetrahedra(sdf, 0.0, spacing, origin,
                                  prefer_native=False)
    rng = np.random.default_rng(3)

    def field(p):
        return np.linalg.norm(p, axis=-1) - 1.0

    np.testing.assert_array_equal(TMESH.orient_faces_outward(v, f, field),
                                  JM.orient_faces_outward(v, f, field))
    np.testing.assert_array_equal(TMESH.face_areas(v, f),
                                  JM.face_areas(v, f))
    np.testing.assert_array_equal(
        TMESH.sample_surface(v, f, 3000, np.random.default_rng(4)),
        JM.sample_surface(v, f, 3000, np.random.default_rng(4)))
    pc = rng.uniform(-1.2, 1.2, (200, 3)).astype(np.float32)
    for a, b in zip(TMESH.crop_mesh_near_pc(v, f, pc, 0.3),
                    JM.crop_mesh_near_pc(v, f, pc, 0.3)):
        np.testing.assert_array_equal(a, b)
    tris = v[f[:50]]
    for a, b in zip(TMESH._weld(tris, spacing, origin),
                    JM._weld(tris, spacing, origin)):
        np.testing.assert_array_equal(a, b)

    # PLY and OBJ: each package reads what the other writes
    colors = rng.integers(0, 255, (len(v), 3)).astype(np.uint8)
    for writer, reader, cols in ((TMESH.write_ply, JM.read_ply, None),
                                 (JM.write_ply, TMESH.read_ply, colors)):
        p = str(tmp_path / "m.ply")
        writer(p, v, f, vert_colors=cols)
        rv, rf = reader(p)
        np.testing.assert_array_equal(rv, v)
        np.testing.assert_array_equal(rf, f)
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                   "f 1/1 2/2 3/3 4/4\nf 1 3 4\n")
    for a, b in zip(TMESH.load_mesh(str(obj)), JM.load_mesh(str(obj))):
        np.testing.assert_array_equal(a, b)

    pts = rng.normal(size=(500, 3)) * np.array([2.0, 0.5, 1.0]) + 0.3
    for a, b in zip(TG.pc_bounds(pts), JG.pc_bounds(pts)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TG.oriented_bounds(pts), JG.oriented_bounds(pts)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_gt_mesh_matches_jax():
    kw = dict(extents=(5.0, 3.0, 4.0))
    got = TDataset(TScene(**kw), n_frames=2, H=8, W=12).gt_mesh(dim=48)
    want = JDataset(JScene(**kw), n_frames=2, H=8, W=12).gt_mesh(dim=48)
    assert len(got[1]) > 1000
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


_PAIR = {}


def _paired():
    """An isdf_tpu and a port Trainer with the same weights and frames at
    grid_dim 64 (the smallest that meshes sparsely), the port's trained
    40 steps and its weights copied into isdf_tpu's."""
    if not _PAIR:
        from isdf_tpu.engine.trainer import Trainer as JTrainer
        from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
        scene = JScene(extents=(5.0, 3.0, 4.0))
        ds = JDataset(scene, n_frames=30, H=24, W=32)
        jt = JTrainer(_small(JConfig), dataset=ds, seed=1, grid_dim=64)
        tt = TTrainer(_small(TConfig), dataset=ds, seed=1, device="cpu",
                      grid_dim=64)
        for tr in (jt, tt):
            for fid in (0, 10, 20):
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
        tt.run_steps(40)
        jt.params = TM.params_to_jax(tt.params, tt.model)
        _PAIR.update(jt=jt, tt=tt)
    return _PAIR["jt"], _PAIR["tt"]


def test_sparse_grid_matches_jax_and_dense_mesh():
    jt, tt = _paired()
    got, frac = tt.get_sdf_grid_sparse()
    want, jfrac = jt.get_sdf_grid_sparse()
    assert frac == jfrac and 0.0 < frac < 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    dense = tt.get_sdf_grid()
    v_d, f_d = TMESH.marching_tetrahedra(dense)
    v_s, f_s = TMESH.marching_tetrahedra(got)
    assert len(f_d) > 0
    np.testing.assert_array_equal(f_s, f_d)
    np.testing.assert_allclose(v_s, v_d, atol=1e-6)


def test_eval_mesh_matches_jax():
    from isdf_tpu.eval import protocol as JP
    from isdf_tpu_torch.eval import protocol as TP
    jt, tt = _paired()
    got = TP.eval_mesh(tt, samples=20000, seed=0)
    want = JP.eval_mesh(jt, samples=20000, seed=0)
    assert 0.0 < got[0] < 2.0 and 0.0 < got[1] < 5.0, got
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the reconstructed meshes themselves
    rv, rf = tt.mesh_rec()
    jv, jf = jt.mesh_rec()
    np.testing.assert_array_equal(rf, jf)
    np.testing.assert_allclose(rv, jv, atol=1e-5)


def test_loop_writes_meshes_and_mesh_eval(tmp_path):
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    ds = TDataset(TScene(extents=(5.0, 3.0, 4.0)), n_frames=30, H=24, W=32)
    cfg = _small(TConfig).replace(save_meshes=True, save_checkpoints=True,
                                  save_period=0.3, mesh_eval=True,
                                  eval_freq_s=0.5)
    tr = Trainer(cfg, dataset=ds, seed=1, device="cpu", grid_dim=64)
    tr._per_step_device_s, tr._bill_exact = 0.01, True
    res = train_loop(tr, max_steps=120, save_path=str(tmp_path))
    assert res.steps == 120 and abs(res.tot_step_time - 1.2) < 1e-6
    meshes = sorted(os.listdir(tmp_path / "meshes"))
    # marks 0.3 (no mesh before 0.4 s of sim time), 0.6, 0.9
    assert meshes == ["0.600.ply", "0.900.ply"], meshes
    v, f = TMESH.read_ply(str(tmp_path / "meshes" / meshes[-1]))
    assert len(f) > 100 and np.isfinite(v).all()
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "step_0.300.ckpt", "step_0.600.ckpt", "step_0.900.ckpt"]
    with open(tmp_path / "res.json") as fh:
        saved = json.load(fh)
    entries = list(saved["mesh_eval"].values())
    # the timed marks at 0.5 and 1.0 s and the final eval
    assert len(entries) == 3
    assert all(set(e) == {"time", "acc", "comp"} and 0.0 < e["acc"] < 2.0
               and 0.0 < e["comp"] < 5.0 for e in entries)
