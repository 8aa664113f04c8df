"""The port's SDF slices (vis/slices.py) against isdf_tpu's on the CPU.

* ``sdf_colormap`` and the viridis table equal isdf_tpu's matplotlib
  colouring exactly.
* ``compute_slices`` / ``write_slices`` on the same weights equal
  isdf_tpu's, except at most 0.1% of pixels, each by one colormap bin (the
  two packages' SDFs differ by float rounding).
* With the camera overlay at most 0.5% of pixels differ, all on a drawn
  shape.
* The rasteriser equals cv2 on set triangles and lines.
* The loop's save hook writes the slices at every save mark.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.vis import slices as JSL
from isdf_tpu_torch.data.sdf_util import _rdbu_lut
from isdf_tpu_torch.vis import slices as SL

CAM = (64, 48, 40.0, 40.0, 31.5, 23.5)
GRID_DIM = 72


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
    """A port trainer trained 60 steps on three frames, and an isdf_tpu
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
        tt.run_steps(60)
        jt.params = jax.tree_util.tree_map(
            jnp.asarray, TM.params_to_jax(tt.params, tt.model))
        yield tt, jt
    finally:
        torch.set_num_threads(threads)


def _bins(table):
    return {tuple(c): i for i, c in enumerate(
        (np.asarray(table)[:, :3] * 255).astype(np.uint8))}


RDBU_BINS = _bins(_rdbu_lut())
VIRIDIS_BINS = _bins(SL.VIRIDIS)


def _assert_close_images(mine, theirs, bins, max_frac=1e-3):
    """Equal but for at most max_frac of the pixels, each one colormap bin
    away."""
    assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
    diff = (mine != theirs).any(-1)
    assert diff.mean() <= max_frac, diff.mean()
    for a, b in zip(mine[diff], theirs[diff]):
        assert abs(bins[tuple(a)] - bins[tuple(b)]) <= 1, (a, b)


def test_sdf_colormap_and_viridis_equal_isdf_tpus():
    import matplotlib
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(-3, 3, 5000), [-2.0, 0.0, 2.0,
                                                      -1e-9, 1e-9, 7.5,
                                                      -7.5, np.nan]])
    for dtype in (np.float32, np.float64):
        v = vals.astype(dtype).reshape(-1, 8)
        for rng_ in ((-2.0, 2.0), (-0.5, 1.5)):
            np.testing.assert_array_equal(SL.sdf_colormap(v, rng_),
                                          JSL.sdf_colormap(v, rng_))
    np.testing.assert_array_equal(
        SL.VIRIDIS, np.asarray(matplotlib.colormaps["viridis"].colors))
    x = np.concatenate([np.linspace(0, 1, 3001), [np.nan]])
    np.testing.assert_array_equal(
        (SL.viridis(x) * 255).astype(np.uint8),
        (matplotlib.colormaps["viridis"](x)[..., :3] * 255).astype(np.uint8))


def test_compute_slices_equal_isdf_tpus(pair):
    tt, jt = pair
    mine = SL.compute_slices(tt, 6, include_gt=True, include_diff=True)
    theirs = JSL.compute_slices(jt, 6, include_gt=True, include_diff=True)
    assert set(mine) == set(theirs) == {"pred_sdf", "gt_sdf", "diff"}
    for key, bins in (("pred_sdf", RDBU_BINS), ("gt_sdf", RDBU_BINS),
                      ("diff", VIRIDIS_BINS)):
        assert len(mine[key]) == 6
        _assert_close_images(np.stack(mine[key]), np.stack(theirs[key]),
                             bins)
    # the slices are not flat: the trained map spans several colours
    assert len(np.unique(np.stack(mine["pred_sdf"]).reshape(-1, 3),
                         axis=0)) > 20


def test_write_slices_files_equal_isdf_tpus(pair, tmp_path):
    tt, jt = pair
    # through each Trainer's write_slices
    tt.write_slices(str(tmp_path / "mine"), prefix="1.000_",
                    include_gt=True, include_diff=True)
    jt.write_slices(str(tmp_path / "theirs"), prefix="1.000_",
                    include_gt=True, include_diff=True)
    names = sorted(os.listdir(tmp_path / "mine"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    assert names == sorted(f"1.000_{k}_{s}.png" for k in ("pred", "gt",
                                                          "diff")
                           for s in range(6))
    for n in names:
        bins = VIRIDIS_BINS if "diff" in n else RDBU_BINS
        # both as BGR, as each package wrote them
        _assert_close_images(cv2.imread(str(tmp_path / "mine" / n)),
                             cv2.imread(str(tmp_path / "theirs" / n)),
                             {k[::-1]: v for k, v in bins.items()})


def test_draw_cams_differs_only_on_drawn_pixels(pair):
    tt, jt = pair
    mine = np.stack(SL.compute_slices(tt, 6, draw_cams=True)["pred_sdf"])
    theirs = np.stack(JSL.compute_slices(jt, 6, draw_cams=True)["pred_sdf"])
    plain = np.stack(SL.compute_slices(tt, 6)["pred_sdf"])
    drawn = (mine != plain).any(-1) | (theirs != plain).any(-1)
    assert drawn.sum() > 50, "no camera was drawn"
    diff = (mine != theirs).any(-1)
    assert diff.mean() <= 5e-3, diff.mean()
    overlay = ((mine == (255, 0, 0)).all(-1) | (mine == (220, 30, 30)).all(-1)
               | (theirs == (255, 0, 0)).all(-1)
               | (theirs == (220, 30, 30)).all(-1))
    # outside the drawn shapes the images differ only by a colormap bin
    off = diff & ~overlay
    assert off.mean() <= 1e-3
    for a, b in zip(mine[off], theirs[off]):
        assert abs(RDBU_BINS[tuple(a)] - RDBU_BINS[tuple(b)]) <= 1


LINES = [((3, 4), (50, 4)), ((3, 4), (3, 40)), ((0, 0), (59, 59)),
         ((50, 10), (5, 30)), ((10, 50), (12, 2)), ((30, 30), (30, 30)),
         ((5, 40), (55, 37)), ((40, 5), (37, 55)), ((20, 20), (8, 14)),
         ((1, 58), (66, 3))]
TRIANGLES = [[[10, 10], [50, 12], [30, 45]], [[39, 2], [24, 50], [33, 3]],
             [[7, 50], [3, 32], [6, 18]], [[5, 5], [40, 5], [20, 30]],
             [[20, 5], [5, 30], [40, 30]], [[5, 5], [20, 20], [35, 35]],
             [[30, 30], [31, 30], [30, 31]], [[60, 2], [2, 40], [65, 55]]]


@pytest.mark.parametrize("p0,p1", LINES)
def test_draw_line_equals_cv2(p0, p1):
    a = np.zeros((60, 70, 3), np.uint8)
    b = a.copy()
    cv2.line(a, p0, p1, (255, 0, 0), 1)
    SL.draw_line(b, p0, p1, (255, 0, 0))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tri", TRIANGLES + [
    (np.array([[0, -1.2], [0.8, 0.9], [-0.8, 0.9]]) * 8 @ np.array(
        [[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]]).T
     + [30, 25]).astype(np.int32).tolist() for r in (0.0, 0.7, 2.1, -2.9)])
def test_fill_poly_equals_cv2(tri):
    tri = np.asarray(tri, np.int32)
    a = np.zeros((60, 70, 3), np.uint8)
    b = a.copy()
    cv2.fillPoly(a, [tri], (220, 30, 30))
    SL.fill_poly(b, tri, (220, 30, 30))
    np.testing.assert_array_equal(a, b)


def test_loop_writes_slices_at_each_save_mark(tmp_path):
    """train_loop with save.save_slices writes six pred PNGs per mark into
    save_path/slices; the last mark's images are the colormap of the
    trainer's sdf_fn on the planes."""
    from isdf_tpu_torch.data.synthetic import (SyntheticDataset,
                                               SyntheticScene)
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils import image_io as IO
    from isdf_tpu_torch.utils.config import Config

    tr = Trainer(_cfg(Config, save_slices=True, save_period=0.1,
                      hidden_feature_size=32),
                 dataset=SyntheticDataset(SyntheticScene(), n_frames=60,
                                          H=48, W=64),
                 seed=1, device="cpu", grid_dim=64)
    tr._per_step_device_s = 0.01
    marks = []
    orig = SL.write_slices

    def spy(trainer, path, prefix=""):
        marks.append((prefix, SL.compute_slices(trainer)["pred_sdf"]))
        return orig(trainer, path, prefix=prefix)

    SL.write_slices = spy
    try:
        train_loop(tr, max_steps=35, save_path=str(tmp_path))
    finally:
        SL.write_slices = orig
    files = sorted(os.listdir(tmp_path / "slices"))
    assert [p for p, _ in marks] == ["0.100_", "0.200_", "0.300_"]
    assert files == sorted(f"{p}pred_{s}.png" for p, _ in marks
                           for s in range(6))
    for prefix, imgs in marks:
        for s, im in enumerate(imgs):
            back = IO.imread(str(tmp_path / "slices" / f"{prefix}pred_{s}"
                                 ".png"))[..., ::-1]
            np.testing.assert_array_equal(back, im)
