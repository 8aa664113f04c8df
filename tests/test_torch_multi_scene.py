"""Multi-scene lockstep training of the port (parallel/multi_scene.py,
train/train_multi.py) against isdf_tpu's on the CPU.

* The stepper gives each scene the same bits as its own train_bundle calls
  by the same step counts, whatever the partner and the partition; masked
  scenes launch nothing and log NaN; billing is joint, floored by the
  step-rate cap.
* multi_scene_loop's schedule (steps per round, ingestion, end of sequence,
  tail, lr anneal, staggered starts and the fleet clock) equals isdf_tpu's
  exactly on the same duck-typed stub trainers.
* A paired two-scene run against isdf_tpu's loop agrees statistically (the
  two packages draw different random numbers).
* The CLI writes each scene's config, res.json ("rays") and a checkpoint
  that isdf_tpu's query engine loads.
"""

import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

from isdf_tpu.parallel import multi_scene as JMS
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu_torch.engine.trainer import Trainer
from isdf_tpu_torch.models import fused_adamw as TA
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.parallel.multi_scene import (MultiSceneStepper,
                                                 multi_scene_loop)
from isdf_tpu_torch.utils.config import Config as TConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    """torch on 2 threads: with several test processes on the machine,
    one spinning thread per core slows concurrent runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def small_cfg(cls=TConfig, **kw):
    cam = cls().camera.__class__(64, 48, 40.0, 40.0, 31.5, 23.5)
    base = dict(dataset_format="synthetic", n_rays=20, n_strat_samples=9,
                n_surf_samples=4, hidden_feature_size=64,
                hidden_layers_block=1, n_embed_funcs=4, kf_buffer_size=12,
                iters_per_frame=10, iters_per_kf=30, bounds_method="pc",
                do_eval=False, mm_precision="highest", do_active=True,
                camera=cam)
    base.update(kw)
    return cls().replace(**base)


def _datasets(n_frames=120):
    return (SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                             n_frames=n_frames, H=48, W=64),
            SyntheticDataset(SyntheticScene(extents=(4.0, 2.6, 6.0)),
                             n_frames=n_frames, H=48, W=64,
                             orbit_radius=1.1))


def _make_pair(seed_a=1, seed_b=2, **cfg_kw):
    """Two different scenes sharing the step's configuration, three frames
    each in the arena."""
    ds_a, ds_b = _datasets()
    cfg = small_cfg(**cfg_kw)
    out = []
    for ds, seed in ((ds_a, seed_a), (ds_b, seed_b)):
        tr = Trainer(cfg, dataset=ds, seed=seed, device="cpu")
        for fid in (0, 40, 80):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
        out.append(tr)
    return out


def _state(tr):
    return ([tr.params[k] for k in sorted(tr.params)]
            + [tr.opt_state[m][k] for m in ("mu", "nu")
               for k in sorted(tr.params)]
            + [tr.buffer.frame_avg_loss, tr.buffer.loss_approx])


def _assert_same_bits(a, b):
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    assert a.opt_state["count"] == b.opt_state["count"]
    assert a.steps_taken == b.steps_taken


def test_stepper_equals_per_scene_bundles():
    """stepper.run_steps(10, n_actives=[3, 7]) then [10, 10] gives each
    scene the bits of its own train_bundle calls of 3 + 4 + 6 and 7 + 10
    steps (Trainer.run_steps), and the scalars of those calls with NaN in
    the untaken tail."""
    tr_a, tr_b = _make_pair()
    ref_a, ref_b = _make_pair()
    _assert_same_bits(tr_a, ref_a)
    stepper = MultiSceneStepper([tr_a, tr_b])
    logs = stepper.run_steps(10, n_actives=[3, 7])
    sa, sb = ref_a.run_steps(3), ref_b.run_steps(7)
    for log, sc, n in ((logs[0], sa, 3), (logs[1], sb, 7)):
        assert set(log) == set(sc)
        for k in sc:
            if k != "step_time_ms":
                assert log[k].shape == (10,)
                np.testing.assert_array_equal(log[k][:n], sc[k])
                assert np.isnan(log[k][n:]).all()
    stepper.run_steps(10)
    ref_a.run_steps(4)
    ref_a.run_steps(6)
    ref_b.run_steps(10)
    _assert_same_bits(tr_a, ref_a)
    _assert_same_bits(tr_b, ref_b)
    assert (tr_a.steps_taken, tr_b.steps_taken) == (13, 17)


def test_masked_steps_are_noops_and_log_nan():
    tr_a, tr_b = _make_pair()
    before = [x.clone() for x in _state(tr_b)]
    calls = []
    fns_b = tr_b.fns
    orig = fns_b.train_bundle
    fns_b.train_bundle = lambda *a, **k: calls.append(1) or orig(*a, **k)
    logs = MultiSceneStepper([tr_a, tr_b]).run_steps(5, n_actives=[5, 0])
    assert not calls, "a masked scene ran its bundle"
    assert tr_b.steps_taken == 0 and tr_a.steps_taken == 5
    for x, y in zip(_state(tr_b), before):
        assert torch.equal(x, y)
    assert np.isnan(logs[1]["total_loss"]).all()
    assert not np.isnan(logs[0]["total_loss"]).any()
    # idle scenes are not billed
    assert tr_b.tot_step_time == 0.0 and tr_a.tot_step_time > 0.0


def test_scenes_are_independent_of_their_partner():
    tr_a, tr_b = _make_pair()
    solo_a, _ = _make_pair()
    tr_c, _ = _make_pair(seed_a=7)   # another partner for the copy of A
    MultiSceneStepper([tr_a, tr_b]).run_steps(6, n_actives=[6, 2])
    MultiSceneStepper([solo_a, tr_c]).run_steps(6, n_actives=[6, 5])
    _assert_same_bits(tr_a, solo_a)


def test_signature_mismatch_and_unported_modes_raise():
    ds_a, _ = _datasets(n_frames=20)
    tr_a = Trainer(small_cfg(), dataset=ds_a, seed=1, device="cpu")
    tr_b = Trainer(small_cfg(n_rays=24), dataset=ds_a, seed=2,
                   device="cpu")
    with pytest.raises(ValueError, match="n_rays"):
        MultiSceneStepper([tr_a, tr_b])
    with pytest.raises(NotImplementedError, match="multi-card"):
        MultiSceneStepper([tr_a], mesh=object())
    with pytest.raises(ValueError, match="at least one"):
        MultiSceneStepper([])


def test_joint_billing_and_the_rate_cap_floor():
    tr_a, tr_b = _make_pair()
    stepper = MultiSceneStepper([tr_a, tr_b])
    stepper.run_steps(4)
    # shared-card clock: both scenes billed the same joint time
    assert tr_a.tot_step_time > 0
    assert tr_a.tot_step_time == tr_b.tot_step_time
    assert tr_a.measured_s == tr_b.measured_s == stepper.measured_s
    # the pinned clock bills n_steps x the pin, once per scene
    stepper._per_step_device_s, stepper._bill_exact = 0.01, True
    t0 = tr_a.tot_step_time
    stepper.run_steps(10, n_actives=[3, 10])
    assert tr_a.tot_step_time - t0 == pytest.approx(0.1)
    assert stepper.last_bundle_dt == pytest.approx(0.1)

    tr_a, tr_b = _make_pair(step_rate_cap=2.0)
    stepper = MultiSceneStepper([tr_a, tr_b])
    stepper._per_step_device_s = 1e-4   # far faster than the cap
    stepper._bill_exact = True
    stepper.run_steps(4, n_actives=[4, 2])
    assert tr_a.tot_step_time == pytest.approx(4 / 2.0)
    assert tr_b.tot_step_time == pytest.approx(2 / 2.0)


def test_max_time_s_stops_the_loop():
    tr_a, tr_b = _make_pair()
    out = multi_scene_loop([tr_a, tr_b], max_steps=10 ** 6,
                           max_time_s=1e-4)
    assert out[0]["steps"] < 100
    assert tr_a.tot_step_time > 1e-4


# ---------------------------------------------------------------------------
# the schedule against isdf_tpu's, on shared stubs
# ---------------------------------------------------------------------------

class StubTrainer:
    """The attributes and methods multi_scene_loop reads, with a keyframe
    decision that is a fixed function of the check count."""

    def __init__(self, cfg, n_frames, kf_period):
        self.cfg = cfg
        self.dataset = range(n_frames)
        self.incremental = True
        self.kf_period = kf_period
        self.steps_since_frame = self.optim_frames = 0
        self.last_is_keyframe = False
        self.tot_step_time = 0.0
        self.noise_std, self.lr_scale, self.tail_mode = 0.1, 1.0, False
        self.buffer = types.SimpleNamespace(count=0)
        self.n_checks = 0
        self.log = []

    def check_keyframe_latest(self):
        if self.last_is_keyframe:
            return True
        self.n_checks += 1
        self.last_is_keyframe = self.n_checks % self.kf_period == 0
        if self.last_is_keyframe:
            self.optim_frames = self.cfg.iters_per_kf
            self.noise_std = self.cfg.noise_kf
            return False
        return True

    def get_latest_frame_id(self):
        return int(self.tot_step_time * self.cfg.fps)

    def get_data(self, idxs):
        return list(idxs)

    def add_frame(self, frame):
        self.log.append(("add", frame, self.tot_step_time))
        if self.last_is_keyframe or self.buffer.count == 0:
            self.buffer.count += 1
        self.steps_since_frame = 0
        self.last_is_keyframe = False
        self.optim_frames = self.cfg.iters_per_frame
        self.noise_std = self.cfg.noise_frame


class RecordingStepper:
    """Records every round and bills a fixed time per step, like a pinned
    stepper."""

    def __init__(self, trainers, per_step_s):
        self.trainers, self.per_step_s = trainers, per_step_s
        self.calls, self.last_bundle_dt, self._compiled = [], 0.0, set()

    def run_steps(self, n_steps, n_actives):
        self.calls.append((n_steps, list(n_actives), [
            (t.lr_scale, t.tail_mode, t.noise_std) for t in self.trainers]))
        self.last_bundle_dt = n_steps * self.per_step_s
        for t, n in zip(self.trainers, n_actives):
            if n > 0:
                t.tot_step_time += (self.last_bundle_dt
                                    / t.cfg.frac_time_perception)
            t.steps_since_frame += n
        return [{} for _ in self.trainers]


SCHEDULES = {
    "staggered": dict(sizes=(40, 25, 60), kf=(3, 2, 5),
                      start_times=[0.0, 0.21, 0.75], max_steps=700,
                      max_time_s=None),
    "late_first_start": dict(sizes=(30, 30), kf=(2, 4),
                             start_times=[0.4, 0.9], max_steps=500,
                             max_time_s=None),
    "capped": dict(sizes=(200, 30), kf=(3, 2), start_times=[0.0, 0.1],
                   max_steps=95, max_time_s=None),
    "timed": dict(sizes=(200, 200), kf=(3, 3), start_times=None,
                  max_steps=260, max_time_s=0.7),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_equals_isdf_tpu(case):
    spec = SCHEDULES[case]
    runs = {}
    for name, loop, cls in (("jax", JMS.multi_scene_loop, JConfig),
                            ("torch", multi_scene_loop, TConfig)):
        cfg = cls().replace(fps=30.0, steps_per_bundle=10,
                            iters_per_frame=10, iters_per_kf=30,
                            tail_lr_min=0.05)
        trainers = [StubTrainer(cfg, n, k)
                    for n, k in zip(spec["sizes"], spec["kf"])]
        stepper = RecordingStepper(trainers, per_step_s=0.004)
        msgs = []
        out = loop(trainers, max_steps=spec["max_steps"],
                   max_time_s=spec["max_time_s"], extra_opt_steps=55,
                   log_fn=msgs.append, start_times=spec["start_times"],
                   stepper=stepper)
        for o in out:
            o.pop("compiled_shapes", None)
        runs[name] = (stepper.calls, [t.log for t in trainers], out, msgs,
                      [(t.tot_step_time, t.lr_scale, t.tail_mode,
                        t.noise_std) for t in trainers])
    assert runs["jax"][0], "no rounds ran"
    assert runs["torch"] == runs["jax"]
    calls = runs["torch"][0]
    if spec["start_times"]:
        # a late scene takes no steps before it joins
        assert calls[0][1][-1] == 0
    if case == "staggered":
        # every scene reached its tail, with the lr annealed below 1
        assert all(any(c[2][i][1] and c[2][i][0] < 1.0 for c in calls)
                   for i in range(3))


# ---------------------------------------------------------------------------
# a paired run against isdf_tpu's loop, and the CLI
# ---------------------------------------------------------------------------

def test_paired_two_scene_run_against_isdf_tpu():
    """Both packages' multi_scene_loop on the same two scenes from the same
    weights, the clock pinned: in each package each scene's loss falls by
    30%, and the final SDF errors agree within a factor of 1.5 per scene
    (the packages draw different random numbers: the runs agree
    statistically, as tests/test_torch_slice.py's paired run)."""
    from isdf_tpu.data.synthetic import SyntheticDataset as JDS
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.trainer import Trainer as JTrainer

    steps, dt = 160, 0.005
    scenes = [dict(extents=(5.0, 3.0, 4.0)), dict(extents=(4.0, 2.6, 6.0))]
    radii = (1.4, 1.1)
    runs = {}
    for name in ("jax", "torch"):
        trainers = []
        for i, (sc, r) in enumerate(zip(scenes, radii)):
            if name == "jax":
                ds = JDS(JScene(**sc), n_frames=60, H=48, W=64,
                         orbit_radius=r)
                tr = JTrainer(small_cfg(JConfig, steps_per_bundle=10),
                              dataset=ds, seed=1 + i)
            else:
                ds = SyntheticDataset(SyntheticScene(**sc), n_frames=60,
                                      H=48, W=64, orbit_radius=r)
                tr = Trainer(small_cfg(steps_per_bundle=10), dataset=ds,
                             seed=1 + i, device="cpu")
                tr.params = TM.params_from_jax(runs["jax_init"][i],
                                               tr.model)
                tr.frozen_params = TM.copy_params(tr.params)
                tr.opt_state = TA.init_state(tr.params)
            trainers.append(tr)
        if name == "jax":
            runs["jax_init"] = [jax.tree_util.tree_map(np.asarray, t.params)
                                for t in trainers]
            stepper = JMS.MultiSceneStepper(trainers)
        else:
            stepper = MultiSceneStepper(trainers)
        stepper._per_step_device_s, stepper._bill_exact = dt, True
        losses = [[] for _ in trainers]
        run_steps = stepper.run_steps

        def rec(n, n_actives=None, run_steps=run_steps, losses=losses):
            out = run_steps(n, n_actives=n_actives)
            for i, sc in enumerate(out):
                v = np.asarray(sc["total_loss"])
                losses[i].extend(v[~np.isnan(v)].tolist())
            return out

        stepper.run_steps = rec
        loop = JMS.multi_scene_loop if name == "jax" else multi_scene_loop
        out = loop(trainers, max_steps=steps, stepper=stepper)
        assert [o["steps"] for o in out] == [steps, steps]
        res = []
        for tr, ls, sc in zip(trainers, losses, scenes):
            rng = np.random.default_rng(0)
            ext = np.asarray(sc["extents"], np.float32)
            pts = (rng.uniform(-1, 1, (4000, 3)) * (ext / 2 - 0.05)
                   ).astype(np.float32)
            mae = float(np.abs(np.asarray(tr.sdf_fn(pts))
                               - tr.dataset.scene.sdf_np(pts)).mean())
            res.append((np.mean(ls[:10]), np.mean(ls[-10:]), mae))
        runs[name] = res
    for name in ("jax", "torch"):
        for first, last, _ in runs[name]:
            assert last < 0.7 * first, runs
    for (_, _, mj), (_, _, mt) in zip(runs["jax"], runs["torch"]):
        assert 1 / 1.5 < mt / mj < 1.5, runs


def _scene_cfg(tmp_path, name, preset):
    cfg = {
        "tpu": {"kf_buffer_size": 12, "mm_precision": "highest"},
        "loss": {"bounds_method": "ray"},
        "sample": {"n_rays": 20, "n_strat_samples": 9,
                   "n_surf_samples": 4},
        "model": {"hidden_feature_size": 32, "hidden_layers_block": 1,
                  "iters_per_frame": 10, "iters_per_kf": 30,
                  "embedding": {"n_embed_funcs": 4}},
        "eval": {"do_eval": 1, "eval_freq_s": 100.0},
        "dataset": {"format": "synthetic", "seq_dir": f"/synthetic/{preset}",
                    "fps": 30,
                    "camera": {"w": 48, "h": 36, "fx": 24.0, "fy": 24.0,
                               "cx": 23.5, "cy": 17.5}},
    }
    path = os.path.join(tmp_path, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_train_multi_cli_on_cpu(tmp_path):
    from isdf_tpu.serve import SDFQueryEngine as JEngine
    from isdf_tpu_torch.serve import SDFQueryEngine
    from isdf_tpu_torch.train.train_multi import main

    cfgs = [_scene_cfg(str(tmp_path), "a", "room_a"),
            _scene_cfg(str(tmp_path), "b", "room_b")]
    out_dir = str(tmp_path / "run")
    out = main(["--config", cfgs[0], "--config", cfgs[1], "--save_path",
                out_dir, "--max_steps", "40", "--seed", "3",
                "--extra_opt_steps", "20", "--device", "cpu"])
    assert len(out) == 2
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (64, 3)).astype(
        np.float32)
    for i in range(2):
        sdir = os.path.join(out_dir, f"scene_{i}")
        with open(os.path.join(sdir, "config.json")) as f, \
                open(cfgs[i]) as g:
            assert json.load(f) == json.load(g)
        with open(os.path.join(sdir, "res.json")) as f:
            res = json.load(f)
        assert res["steps"] == out[i]["steps"] > 0
        assert res["n_keyframes"] >= 1
        (entry,) = res["sdf_eval"].values()
        assert set(entry["rays"]) == {"av_l1", "binned_l1",
                                      "l1_chomp_costs"}
        assert math.isfinite(entry["rays"]["av_l1"])
        ckpt = os.path.join(sdir, "final.ckpt")
        mine = SDFQueryEngine.from_checkpoint(ckpt, device="cpu").sdf(pts)
        theirs = np.asarray(JEngine.from_checkpoint(ckpt).sdf(pts))
        assert np.isfinite(mine).all()
        np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-6)
