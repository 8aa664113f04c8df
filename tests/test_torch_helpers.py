"""The port's small public helpers against isdf_tpu's on the CPU: the
geometry conventions and the camera spline (ops/geometry.py), the PE width
(ops/embedding.py), the host frame store's batches (data/frame_store.py),
the host timer (eval/metrics.py), the parameter count (models/sdf_mlp.py)
and the Trainer's frames_vis, latest_frame_vis and clear_keyframes, the
last followed by graph-route bundles that must give the eager loop's
bits."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.data import frame_store as JFS
from isdf_tpu.eval import metrics as JMe
from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.ops import embedding as JE
from isdf_tpu.ops import geometry as JG
from isdf_tpu_torch.data import frame_store as TFS
from isdf_tpu_torch.eval import metrics as TMe
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import embedding as TE
from isdf_tpu_torch.ops import geometry as TG
from isdf_tpu_torch.vis import views as TVW
from test_torch_graphs import FakeRunner


@pytest.fixture(autouse=True)
def _two_threads():
    """torch on 2 threads: with several test processes on the machine,
    one spinning thread per core slows concurrent runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("axis,deg", [([1, 0, 0], -180), ([0, 0, 1], 180),
                                      ([0.3, -1.2, 0.5], 37.5),
                                      ([0, 2, 0], 0.0)])
def test_rotation_about(axis, deg):
    np.testing.assert_array_equal(TG.rotation_about(axis, deg),
                                  JG.rotation_about(axis, deg))


def test_camera_conventions():
    T = np.random.default_rng(0).normal(size=(4, 4))
    for name in ("to_trimesh", "to_replica"):
        for t in (None, T):
            np.testing.assert_array_equal(getattr(TG, name)(t),
                                          getattr(JG, name)(t))


def test_spline_interpolation():
    kp = np.random.default_rng(1).normal(size=(6, 3))
    got = TG.spline_interpolation(kp, 50)
    assert got.shape == (50, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, JG.spline_interpolation(kp, 50))
    np.testing.assert_allclose(got[[0, -1]], kp[[0, -1]], atol=1e-12)


@pytest.mark.parametrize("degs", [(0, 5), (0, 3), (2, 8), (0, 0)])
def test_embedding_size(degs):
    assert TE.embedding_size(*degs) == JE.embedding_size(*degs)
    assert TE.embedding_size() == JE.embedding_size() == 255


def test_frame_store_batches():
    rng = np.random.default_rng(2)
    stores = (TFS.FrameStore(), JFS.FrameStore())
    for i in range(4):
        im = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
        d = rng.uniform(0, 3, (6, 8)).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        for mod, st in zip((TFS, JFS), stores):
            st.add(mod.FrameData(frame_id=i, image=im, depth=d, T_WC=T),
                   replace=i == 3)
    t, j = stores
    assert len(t) == len(j) == 3
    for name in ("depth_batch_np", "im_batch_np", "T_WC_batch_np"):
        a, b = getattr(t, name)(), getattr(j, name)()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_start_and_end_timing_are_host_milliseconds():
    s = TMe.start_timing()
    time.sleep(0.02)
    ms_t = TMe.end_timing(s)
    ms_j = JMe.end_timing(s)
    assert 20.0 <= ms_t <= ms_j < ms_t + 50.0
    assert abs(JMe.start_timing() - TMe.start_timing()) < 0.05


@pytest.mark.parametrize("kw", [
    {}, dict(hidden_size=64, hidden_layers_block=1, max_deg=3,
             embedding_size=JE.embedding_size(0, 3)),
    dict(hidden_size=32, hidden_layers_block=2, max_deg=2,
         embedding_size=JE.embedding_size(0, 2)),
    dict(gauss_embed=True), dict(hidden_size=48, embedding_size=129)])
def test_param_count_equals_isdf_tpus(kw):
    jm, tm = JM.SDFModel(**kw), TM.SDFModel(**kw)
    pj = JM.init_params(jax.random.PRNGKey(0), jm)
    pt = TM.init_params(torch.Generator().manual_seed(0), tm)
    assert TM.param_count(pt, tm) == JM.param_count(pj)
    # the packed planes hold padding the count leaves out
    assert TM.param_count(pt, tm) < sum(v.numel() for v in pt.values()) or \
        kw.get("gauss_embed")


# ------------------------------------------------------ Trainer helpers

def _cfg(cls, **kw):
    cam = cls().camera.__class__(64, 48, 40.0, 40.0, 31.5, 23.5)
    base = dict(dataset_format="synthetic", n_rays=20, n_strat_samples=9,
                n_surf_samples=4, hidden_feature_size=64,
                hidden_layers_block=1, n_embed_funcs=4, kf_buffer_size=12,
                iters_per_frame=10, iters_per_kf=30, bounds_method="pc",
                do_eval=False, mm_precision="highest", camera=cam)
    base.update(kw)
    return cls().replace(**base)


@pytest.fixture(scope="module")
def pair():
    """A port trainer trained 10 steps on three frames, and an isdf_tpu
    trainer on the same scene with its weights and frames."""
    from isdf_tpu.data.synthetic import SyntheticDataset as JDS
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.utils.config import Config as JConfig
    from isdf_tpu_torch.data.synthetic import (SyntheticDataset,
                                               SyntheticScene)
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        tt = Trainer(_cfg(Config), dataset=SyntheticDataset(
            SyntheticScene(), n_frames=60, H=48, W=64), seed=1,
            device="cpu", grid_dim=16)
        jt = JTrainer(_cfg(JConfig), dataset=JDS(
            JScene(), n_frames=60, H=48, W=64), seed=1, grid_dim=16)
        for tr in (tt, jt):
            for fid in (0, 20, 40):
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
        tt.run_steps(10)
        jt.params = jax.tree_util.tree_map(
            jnp.asarray, TM.params_to_jax(tt.params, tt.model))
        yield tt, jt
    finally:
        torch.set_num_threads(threads)


def test_frames_vis_equals_isdf_tpus(pair):
    tt, jt = pair
    for rf in (6, 4):
        got = tt.frames_vis(reduce_factor=rf)
        np.testing.assert_array_equal(got, jt.frames_vis(reduce_factor=rf))
        np.testing.assert_array_equal(got, TVW.keyframe_strip(tt, rf))


def test_latest_frame_vis_method(pair):
    """The method is vis/views.py's function (held to isdf_tpu's render in
    tests/test_torch_train_vis.py); its rgb and GT-depth quadrants equal
    isdf_tpu's exactly."""
    tt, jt = pair
    got = tt.latest_frame_vis()
    np.testing.assert_array_equal(got, TVW.latest_frame_vis(tt))
    want = jt.latest_frame_vis()
    assert got.shape == want.shape
    h = got.shape[0] // 2
    np.testing.assert_array_equal(got[:h], want[:h])


def test_clear_keyframes_equals_isdf_tpus():
    from isdf_tpu.data.synthetic import SyntheticDataset as JDS
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.utils.config import Config as JConfig
    from isdf_tpu_torch.data.synthetic import (SyntheticDataset,
                                               SyntheticScene)
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config

    tt = Trainer(_cfg(Config), dataset=SyntheticDataset(
        SyntheticScene(), n_frames=30, H=48, W=64), seed=1, device="cpu")
    jt = JTrainer(_cfg(JConfig), dataset=JDS(JScene(), n_frames=30, H=48,
                                             W=64), seed=1)
    for tr in (tt, jt):
        for fid in (0, 10):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
        tr.steps_since_frame = 3
        tr.clear_keyframes()
    depth = tt.buffer.depth
    assert len(tt.frames) == len(jt.frames) == 0
    assert tt.buffer.count == int(jt.buffer.count) == 0
    assert tt.buffer.depth is depth          # emptied in place
    for name in ("depth", "T_WC", "normals", "frame_avg_loss",
                 "loss_approx", "frame_id"):
        np.testing.assert_array_equal(getattr(tt.buffer, name).numpy(),
                                      np.asarray(getattr(jt.buffer, name)))
    for name in ("last_is_keyframe", "steps_since_frame", "optim_frames"):
        assert getattr(tt, name) == getattr(jt, name)


def test_clear_keyframes_then_graph_bundles_give_eager_bits():
    """Bundles captured on the first frames, then clear_keyframes and new
    frames: the graphs replay on the emptied arena, with the eager loop's
    bits."""
    from test_torch_graphs import DATASET, _state, small_cfg
    from isdf_tpu_torch.engine.trainer import Trainer
    out = []
    for graph in (False, True):
        tr = Trainer(small_cfg(), dataset=DATASET, seed=3, device="cpu")
        if graph:
            tr.fns.graphs = FakeRunner()
            tr.fns.eager = False
        logs = []
        for fids in ((0, 10, 20), (50, 60)):
            for fid in fids:
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
                logs.append(tr.run_steps(4)["total_loss"])
            tr.clear_keyframes()
        out.append((np.concatenate(logs), _state(tr)))
        if graph:
            # one key while the arena holds no more than a window: the
            # capture of the first frames served after the clear
            assert tr.fns.graphs.stats["captures"] == 1
            assert tr.fns.graphs.stats["replays"] > 0
    (la, sa), (lb, sb) = out
    assert np.array_equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
