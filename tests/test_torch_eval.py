"""The port's eval protocol and metrics against isdf_tpu's on the CPU.

* The metrics functions: both packages run the same numpy and scipy code,
  so the same inputs give the same numbers (rtol 1e-12).
* SceneCache: the same frames.
* eval_sdf and eval_grad_cossim: the same weights (params_from_jax), the
  same frames, clock and seed sample the same points in both packages;
  the scores then differ only by the two MLPs' float32 round-off: av_l1,
  binned_l1 and the CHOMP costs within rtol 1e-5, the cosine distance
  within 1e-5 absolute.
* The loop's do_eval: entries keyed "rays", each the protocol's output at
  its timestamp's seed.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from isdf_tpu.data.datasets import SceneCache as JSceneCache
from isdf_tpu.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu.eval import metrics as JMET
from isdf_tpu.eval import protocol as JP
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.data.datasets import SceneCache as TSceneCache
from isdf_tpu_torch.eval import metrics as TMET
from isdf_tpu_torch.eval import protocol as TP
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils.config import Config as TConfig

from test_torch_slice import _small

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _metric_inputs(name, rng):
    sdf = rng.normal(size=500) * 1.5
    if name in ("chomp_cost", "linear_cost"):
        return (sdf, 1.5)
    if name == "binned_losses":
        gt = rng.normal(size=500) * 0.6
        gt[gt > 1.0] = 0.05  # an empty top bin: NaN in both
        return (np.abs(sdf - gt), gt)
    if name == "aligned_ate":
        return (rng.normal(size=(40, 3)), rng.normal(size=(40, 3)))
    return (rng.normal(size=(300, 3)), rng.normal(size=(200, 3)))


@pytest.mark.parametrize("name", [
    "chomp_cost", "linear_cost", "binned_losses", "accuracy", "completion",
    "completion_ratio", "aligned_ate"])
def test_metrics_match_jax(name):
    args = _metric_inputs(name, np.random.default_rng(0))
    got = np.asarray(getattr(TMET, name)(*args), np.float64)
    want = np.asarray(getattr(JMET, name)(*args), np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)


def test_scene_cache_matches_jax():
    ds = SyntheticDataset(SyntheticScene(), n_frames=23, H=12, W=16)
    tc, jc = TSceneCache(ds, skip=5), JSceneCache(ds, skip=5)
    assert len(tc) == len(jc) == 23
    for idxs in ([0], np.arange(13), [22, 3, 4], []):
        a, b = tc[idxs], jc[idxs]
        for k in ("depth", "T"):
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tc.get_all()["T"], jc.get_all()["T"])


_PAIR = {}


def _paired():
    """A JAX and a port Trainer on one synthetic dataset with the same
    weights and clock (built once per test process)."""
    if not _PAIR:
        from isdf_tpu.engine.trainer import Trainer as JTrainer
        from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
        scene = SyntheticScene(extents=(5.0, 3.0, 4.0))
        ds = SyntheticDataset(scene, n_frames=40, H=24, W=32)
        jt = JTrainer(_small(JConfig), dataset=ds, seed=1, grid_dim=8)
        tt = TTrainer(_small(TConfig), dataset=ds, seed=1, device="cpu",
                      grid_dim=8)
        tt.params = TM.params_from_jax(jt.params, tt.model)
        jt.tot_step_time = tt.tot_step_time = 0.4  # 12 frames seen
        _PAIR.update(jt=jt, tt=tt)
    return _PAIR["jt"], _PAIR["tt"]


@pytest.mark.parametrize("visible,incremental", [
    (True, True), (True, False), (False, True)])
def test_eval_sdf_matches_jax(visible, incremental):
    jt, tt = _paired()
    jt.incremental = tt.incremental = incremental
    try:
        want = JP.eval_sdf(jt, samples=6000, visible_region=visible, seed=7)
        got = TP.eval_sdf(tt, samples=6000, visible_region=visible, seed=7)
        again = TP.eval_sdf(tt, samples=6000, visible_region=visible, seed=7)
    finally:
        jt.incremental = tt.incremental = True
    assert sorted(got) == sorted(want) == ["av_l1", "binned_l1",
                                          "l1_chomp_costs"]
    np.testing.assert_allclose(got["av_l1"], want["av_l1"], rtol=1e-5)
    np.testing.assert_allclose(got["binned_l1"], want["binned_l1"],
                               rtol=1e-5, equal_nan=True)
    np.testing.assert_allclose(got["l1_chomp_costs"],
                               want["l1_chomp_costs"], rtol=1e-5)
    assert got == again


def test_eval_grad_cossim_matches_jax():
    jt, tt = _paired()
    want = JP.eval_grad_cossim(jt, samples=3000, seed=3)
    got = TP.eval_grad_cossim(tt, samples=3000, seed=3)
    assert 0.0 < got < 2.0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_loop_do_eval_writes_the_protocol(tmp_path):
    """With eval.do_eval and no hook, each res.json entry is the
    protocol's output under "rays", seeded by its timestamp."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    ds = SyntheticDataset(SyntheticScene(), n_frames=30, H=24, W=32)
    tr = Trainer(_small(TConfig).replace(do_eval=True, eval_freq_s=0.25,
                                         hidden_feature_size=32),
                 dataset=ds, device="cpu", grid_dim=4)
    tr._per_step_device_s = 0.01
    res = train_loop(tr, max_steps=60, save_path=str(tmp_path))
    with open(tmp_path / "res.json") as f:
        saved = json.load(f)
    entries = list(saved["sdf_eval"].values())
    assert len(entries) >= 2 and saved["kf_indices"] == res.kf_indices
    for e in entries:
        assert set(e) == {"time", "rays"}
        assert set(e["rays"]) == {"av_l1", "binned_l1", "l1_chomp_costs"}
    last = TP.eval_sdf(tr, visible_region=True,
                       seed=int(tr.tot_step_time * 1e3))
    np.testing.assert_allclose(entries[-1]["rays"]["av_l1"], last["av_l1"],
                               rtol=1e-6)
