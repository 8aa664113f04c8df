"""The port's own copies of the config loader and the synthetic scene
against isdf_tpu's on the CPU.

* Config: every shipped ``isdf_tpu/train/configs/*.json`` parses into the
  same Config through both loaders, field by field, with and without
  overrides; exact equality.
* Synthetic scene: the analytic SDF at random points (atol 1e-6), the
  sphere-traced depth of a small camera on the orbit (the hit masks agree
  on at least 99.5% of the pixels, depths where both hit within 1e-4 m),
  and the orbit's poses (atol 1e-6).
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.data import synthetic as JS
from isdf_tpu.utils import config as JC
from isdf_tpu_torch.data import synthetic as TS
from isdf_tpu_torch.utils import config as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "isdf_tpu", "train", "configs",
                                        "*.json")))
OVERRIDES = ["loss.bounds_method=ray", "model.hidden_layers_block=1",
             "optimiser.lr=0.0005", "trainer.steps=300",
             "sample.n_rays=64"]


def test_every_shipped_config_is_covered():
    names = {os.path.basename(p) for p in CONFIGS}
    assert len(names) == 6 and "synthetic.json" in names


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
@pytest.mark.parametrize("overrides", [None, OVERRIDES],
                         ids=["as_shipped", "overrides"])
def test_config_parses_like_jax(path, overrides):
    j = JC.load_config(path, overrides=overrides)
    t = TC.load_config(path, overrides=overrides)
    dj, dt = dataclasses.asdict(j), dataclasses.asdict(t)
    assert dt.keys() == dj.keys()
    for k in dj:
        assert dt[k] == dj[k], k
    for prop in ("do_normal", "n_samples_per_ray", "embedding_size", "live"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_port_config_copy_is_the_shipped_one():
    a = TC.load_config(os.path.join(ROOT, "isdf_tpu_torch", "train",
                                    "configs", "synthetic.json"))
    b = JC.load_config(os.path.join(ROOT, "isdf_tpu", "train", "configs",
                                    "synthetic.json"))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("preset", sorted(TS.SCENE_PRESETS))
def test_scene_sdf_matches_jax(preset):
    assert TS.SCENE_PRESETS[preset] == JS.SCENE_PRESETS[preset]
    pts = np.random.default_rng(0).uniform(-4, 4, (4000, 3)).astype(np.float32)
    np.testing.assert_allclose(TS.make_scene(preset).sdf_np(pts),
                               JS.make_scene(preset).sdf_np(pts), atol=1e-6)


def _datasets(n_frames=12, H=24, W=32):
    kw = dict(n_frames=n_frames, H=H, W=W)
    return (TS.SyntheticDataset(TS.make_scene("room_a"), **kw),
            JS.SyntheticDataset(JS.make_scene("room_a"), **kw))


def test_orbit_poses_and_camera_match_jax():
    t, j = _datasets()
    assert t.camera() == j.camera()
    np.testing.assert_allclose(np.stack(t.poses), np.stack(j.poses),
                               atol=1e-6)
    for a, b in zip(t.scene_bounds(), j.scene_bounds()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("idx", [0, 5, 11])
def test_rendered_depth_matches_jax(idx):
    t, j = _datasets()
    dt, dj = t[idx]["depth"], j[idx]["depth"]
    assert dt.shape == dj.shape == (24, 32) and dt.dtype == np.float32
    np.testing.assert_array_equal(t[idx]["T"], j[idx]["T"])
    hit_t, hit_j = dt > 0, dj > 0
    assert hit_t.mean() > 0.9
    assert (hit_t == hit_j).mean() >= 0.995
    both = hit_t & hit_j
    np.testing.assert_allclose(dt[both], dj[both], atol=1e-4)


def test_render_depth_on_torch_tensors_matches_jax():
    """SyntheticScene.render_depth itself, on the dataset's ray grid."""
    t, j = _datasets()
    T = t.poses[3]
    a = t.scene.render_depth(torch.as_tensor(T), t._dirs_C).numpy()
    b = np.asarray(j.scene.render_depth(jnp.asarray(T), j._dirs_C))
    both = (a > 0) & (b > 0)
    assert ((a > 0) == (b > 0)).mean() >= 0.995
    np.testing.assert_allclose(a[both], b[both], atol=1e-4)
