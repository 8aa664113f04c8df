"""Multi-scene lockstep training: K independent SDF maps on one card
(isdf_tpu/parallel/multi_scene.py).

The reference gives each scene its own process and GPU (isdf/train/
train.py:283, one synchronous Trainer loop); mapping K scenes there takes K
GPUs. Here K trainers time-share one card: each round, every active scene
runs its own steps, one scene after another on the card's stream, and
every billed scene's simulated clock is billed the whole round's device
time. Each robot sees the whole wall clock while it receives its share of
the card's steps, so a K-scene deployment keeps real time only if the
round's step rate divided by K still clears the sequence's budget.

Scenes are independent: datasets, poses, scene frames, noise schedules,
refinement tails and start times (``multi_scene_loop(start_times=...)``)
may differ. Step t of a scene draws from its own generator seeded with
(its seed, its global step) (engine/step.py), so a scene trained beside
others gives the same bits as the same scene trained alone by the same
step counts. The scenes must share the step's configuration
(``_HOT_FIELDS``) and camera, as isdf_tpu's one compiled program requires:
the port keeps the rule so that a configuration runs in both packages or
in neither.

What differs from isdf_tpu: its round is one compiled program (``lax.map``
over stacked per-scene state, ``lax.cond`` skipping idle scenes, the big
arena planes selected by ``lax.switch`` so they are never stacked). The
port's round is a loop over the scenes: each trainer's state is updated in
place, a scene with no active steps launches nothing, and nothing is
stacked or copied, so the card holds exactly the K trainers' own state.
Device time is read from CUDA events around the whole round (isdf_tpu's
differential calibration of a fetch-synced wall has no counterpart). Fleet
mode (the scene axis sharded over a ``mesh=`` of devices) needs several
cards and is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from isdf_tpu_torch.engine.trainer import Trainer, pinned_dt
from isdf_tpu_torch.utils.profiling import BundleClock

# the config fields of isdf_tpu's compiled step body (its step.py::
# build_step_functions closes over them): scenes stepped together must
# agree on all of them. Dataset, scene frame, noise schedule and clock
# state are free to differ.
_HOT_FIELDS = (
    "n_rays", "window_size", "n_strat_samples", "n_surf_samples",
    "min_depth", "dist_behind_surf", "do_active", "active_frac",
    "bounds_method", "loss_type", "trunc_weight", "trunc_distance",
    "eik_weight", "eik_apply_dist", "grad_weight", "orien_loss",
    "lr", "weight_decay", "scale_output", "scale_input",
    "n_embed_funcs", "gauss_embed", "hidden_layers_block",
    "hidden_feature_size", "optim_embedding", "compute_dtype",
    "mm_precision", "grad_mode", "pallas_interpret", "pe_in_kernel",
    "pc_in_kernel", "pc_surf_budget", "use_pallas", "kf_buffer_size",
    "noisy_depth",
)


def _hot_signature(trainer: Trainer):
    return tuple(getattr(trainer.cfg, f) for f in _HOT_FIELDS) + (
        trainer.H, trainer.W)


class MultiSceneStepper:
    """Lockstep stepping of K Trainers (scenes) on one card.

    ``stepper.run_steps(n)`` advances every scene by its own number of
    steps and does each trainer's run_steps bookkeeping (clock billing,
    step counters, scalar logs) with the round's joint device time.
    """

    def __init__(self, trainers: Sequence[Trainer], mesh=None):
        if len(trainers) < 1:
            raise ValueError("need at least one trainer")
        if mesh is not None:
            raise NotImplementedError(
                "fleet mode (mesh=, the scenes sharded over several "
                "devices) needs a multi-card host and is not ported to "
                "isdf_tpu_torch")
        t0 = trainers[0]
        sig0 = _hot_signature(t0)
        for t in trainers[1:]:
            if _hot_signature(t) != sig0:
                diff = [f for f in _HOT_FIELDS
                        if getattr(t.cfg, f) != getattr(t0.cfg, f)]
                raise ValueError(
                    "scenes must share the step's configuration; "
                    f"differing fields: {diff or ['camera H/W']}")
        if any(t.cfg.data_parallel > 1 for t in trainers):
            raise ValueError("multi-scene with data parallelism is not "
                             "supported")
        if len({t.device for t in trainers}) != 1:
            raise ValueError("the scenes must share one device")
        self.trainers: List[Trainer] = list(trainers)
        self.K = len(self.trainers)
        self.device = t0.device
        # > 0: bill this many seconds per step of a round instead of its
        # measured time, capped by it unless _bill_exact (pinned_dt)
        self._per_step_device_s = 0.0
        self._bill_exact = False
        self.last_bundle_dt = 0.0   # seconds billed for the last round
        self.measured_s = 0.0       # summed measured device time of rounds
        self._names: List[str] = []

    def run_steps(self, n_steps: int,
                  n_actives: Optional[Sequence[int]] = None,
                  ) -> List[Dict[str, np.ndarray]]:
        """Advance scene i by ``n_actives[i]`` (default: all ``n_steps``)
        steps. Returns the per-scene scalar logs, each [n_steps]; steps a
        scene did not take log NaN.

        Clock: every scene with active steps is billed the whole round's
        device time (Trainer._bill: ``dt / frac_time_perception`` each,
        floored by ``n_active / step_rate_cap`` where a cap is set), as if
        K reference processes time-shared one card; an idle scene is not
        billed."""
        if n_actives is None:
            n_actives = [n_steps] * self.K
        n_actives = [int(min(max(n, 0), n_steps)) for n in n_actives]
        clock = BundleClock(self.device)
        outs = {}
        for i, (tr, na) in enumerate(zip(self.trainers, n_actives)):
            if na == 0:
                continue
            outs[i] = tr.fns.train_bundle(
                tr.params, tr.opt_state, tr.buffer, tr.transform_dev,
                tr._bundle_seed, float(tr.noise_std), n_steps=na,
                lr_scale=float(tr.lr_scale), tail=bool(tr.tail_mode),
                step0=tr.steps_taken)
        clock.stop()
        if outs:
            self._names = sorted(next(iter(outs.values())))
        names = self._names
        # one fetch of every scene's scalars: the round's sync
        flat = (torch.cat([outs[i][k] for i in sorted(outs) for k in names])
                .cpu().numpy() if outs and names else np.zeros(0))
        measured = clock.seconds()
        self.measured_s += measured
        dt = pinned_dt(n_steps, measured, self._per_step_device_s,
                       self._bill_exact)
        self.last_bundle_dt = dt

        results, at = [], 0
        for i, tr in enumerate(self.trainers):
            na = n_actives[i]
            sc = {}
            for k in names:
                col = np.full(n_steps, np.nan, np.float32)
                if i in outs:
                    col[:na] = flat[at:at + na]
                    at += na
                sc[k] = col
            if na > 0:
                tr._bill(dt, na, measured)
            sc["step_time_ms"] = np.full(n_steps, 1e3 * dt / n_steps)
            results.append(sc)
        return results


def multi_scene_loop(
    trainers: Sequence[Trainer],
    max_steps: int = None,
    max_time_s: float = None,
    extra_opt_steps: int = 400,
    log_fn=None,
    start_times: Optional[Sequence[float]] = None,
    stepper: Optional[MultiSceneStepper] = None,
) -> List[dict]:
    """The headless loop over K scenes in lockstep (engine/loop.py's
    structure). Per round, each started scene runs its own ingestion and
    keyframe state machine (engine/loop.py step 1), then one stepper round
    of the fixed length steps_per_bundle (10 if unset) advances every
    scene by its own budget. A scene whose sequence and refinement tail
    have ended, or whose ``start_times[i]`` the fleet clock has not
    reached, takes no steps that round.

    ``start_times``: per-scene fleet-clock offsets in seconds; scene i
    joins once the fleet has run that long, and its own simulated clock
    (so its camera stream) starts then, like launching the reference's
    one-process-per-scene train.py (isdf/train/train.py:282-358) later.

    Returns per-scene summaries (steps, sim time, keyframe count).
    """
    trainers = list(trainers)
    K = len(trainers)
    if stepper is None:
        stepper = MultiSceneStepper(trainers)
    cfgs = [t.cfg for t in trainers]
    sizes = [len(t.dataset) for t in trainers]
    max_steps = max_steps if max_steps is not None else min(
        c.n_steps for c in cfgs)
    B = max(int(cfgs[0].steps_per_bundle) or 10, 1)
    start_times = ([0.0] * K if start_times is None
                   else [float(s) for s in start_times])
    started = [s <= 0.0 for s in start_times]
    fleet_time = 0.0
    t_steps = [0] * K
    break_at = [-1] * K
    tail_start = [0] * K
    done = [False] * K
    rounds = 0

    while not all(done):
        live = [i for i in range(K) if not done[i]]
        if all(t_steps[i] >= max_steps for i in live):
            break
        if max_time_s is not None:
            billed = [trainers[i].tot_step_time for i in live
                      if started[i]]
            if billed and min(billed) > max_time_s:
                break
        # ---- staggered activation (fleet clock) ----
        if not any(started):
            # nothing runs yet: jump the fleet clock to the first start
            fleet_time = min(start_times)
        for i in range(K):
            if not started[i] and fleet_time >= start_times[i] - 1e-9:
                started[i] = True
                if log_fn:
                    log_fn(f"scene {i}: joins the fleet at fleet "
                           f"t={fleet_time:.2f}s")

        n_actives = [0] * K
        for i, tr in enumerate(trainers):
            cfg, t = cfgs[i], t_steps[i]
            if done[i] or not started[i]:
                continue
            if max_steps - t <= 0:
                # a capped scene waiting for the others: idle, and no
                # ingestion either (the solo loop stops before ingesting
                # past max_steps)
                continue
            finish_optim = tr.steps_since_frame == tr.optim_frames
            if tr.incremental and (finish_optim or t == 0):
                add_new = True if t == 0 else tr.check_keyframe_latest()
                if add_new:
                    fid = tr.get_latest_frame_id()
                    if fid >= sizes[i]:
                        if break_at[i] < 0:
                            break_at[i] = t + extra_opt_steps
                            tail_start[i] = t
                            tr.noise_std = 0.0
                            tr.tail_mode = cfg.tail_loss_window
                            if log_fn:
                                log_fn(f"scene {i}: end of sequence at "
                                       f"step {t}; tail {extra_opt_steps}")
                    else:
                        tr.add_frame(tr.get_data([fid])[0])
                        if t == 0:
                            tr.last_is_keyframe = True
                            tr.optim_frames = 200
            if break_at[i] >= 0 and t >= break_at[i]:
                done[i] = True
                continue
            budget = max(tr.optim_frames - tr.steps_since_frame, 1)
            if break_at[i] > 0:
                budget = max(min(break_at[i] - t, 100), 1)
                frac = min(max((t - tail_start[i])
                               / max(extra_opt_steps, 1), 0.0), 1.0)
                lo = cfg.tail_lr_min
                tr.lr_scale = lo + (1.0 - lo) * 0.5 * (
                    1.0 + np.cos(np.pi * frac))
            n_actives[i] = min(budget, B, max_steps - t)

        if not any(n_actives):
            if any(not s for s in started):
                # every running scene is capped or done but a staggered
                # scene still waits: jump the fleet clock to its start
                fleet_time = min(start_times[i] for i in range(K)
                                 if not started[i])
                continue
            break
        # scenes with active steps are billed the whole round (shared-card
        # clock); idle scenes launch nothing and are not billed
        stepper.run_steps(B, n_actives=n_actives)
        fleet_time += stepper.last_bundle_dt / max(
            cfgs[0].frac_time_perception, 1e-9)
        for i in range(K):
            t_steps[i] += n_actives[i]
        rounds += 1
        if log_fn and rounds % 20 == 0:
            msg = "  ".join(
                f"s{i}:t={tr.tot_step_time:.1f}s"
                for i, tr in enumerate(trainers))
            log_fn(f"round {rounds} steps={t_steps} {msg}")

    return [{
        "steps": t_steps[i],
        "tot_step_time": trainers[i].tot_step_time,
        "n_keyframes": int(trainers[i].buffer.count),
    } for i in range(K)]
