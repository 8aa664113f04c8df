"""The headless training loop (isdf_tpu/engine/loop.py; reference
isdf/train/train.py:19-279).

Per round:
  1. if the per-frame iteration budget is spent, run the keyframe state
     machine and possibly ingest the frame at int(tot_step_time * fps)
     (incremental mode only); with model.refine_poses, a pose burst then
     tracks the ingested frame against the map (engine/pose.py);
  2. run the remaining budget as one bundle of steps, or one step with
     ``bundle=False`` (the reference's per-step loop);
  3. at sim-time marks every save.save_period seconds: checkpoints, SDF
     slices and meshes (save.save_checkpoints, save.save_slices,
     save.save_meshes);
  4. the fixed-point (voxblox-comparable) eval at its pre-baked
     timestamps (eval.do_vox_comparison), into vox_res.json;
  5. timed evals: ``eval_hook``, else with eval.do_eval the reference
     protocol (eval/protocol.py::eval_sdf over the visible region, seeded
     by the timestamp), keyed "rays" in res.json; with eval.mesh_eval the
     mesh's accuracy and completion against the GT mesh ("mesh_eval").

After the last frame, a refinement tail of ``extra_opt_steps`` runs with
the output noise off, the window drawn from all keyframes and the lr
cosine-annealed to tail_lr_min; then a final eval of the settled model.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from isdf_tpu_torch.engine.trainer import Trainer


@dataclasses.dataclass
class LoopResult:
    steps: int
    rounds: int
    sdf_evals: Dict
    kf_indices: List[int]
    tot_step_time: float
    wall_time: float
    losses_last: Dict[str, float]


def _timed_eval(trainer: Trainer, eval_hook):
    """One eval entry: the hook's, else with eval.do_eval the reference
    protocol's (isdf_tpu loop.py:219-228), sampled with a seed fixed by the
    timestamp; else None."""
    if eval_hook is not None:
        return eval_hook(trainer)
    if not trainer.cfg.do_eval:
        return None
    from isdf_tpu_torch.eval.protocol import eval_sdf
    return {"rays": eval_sdf(trainer, visible_region=True,
                             seed=int(trainer.tot_step_time * 1e3))}


def _mesh_eval(trainer: Trainer, res: Dict, t: int):
    """The mesh's accuracy and completion against the GT mesh at a timed
    mark (reference train.py:267-275), into res["mesh_eval"][t]."""
    from isdf_tpu_torch.eval.protocol import eval_mesh
    acc, comp = eval_mesh(trainer, samples=50000, seed=0)
    res.setdefault("mesh_eval", {})[t] = {
        "time": trainer.tot_step_time, "acc": float(acc),
        "comp": float(comp)}


def _save_marks(trainer: Trainer, save_path: str, save_t: str, t: int):
    """Checkpoint, slices and mesh at one save mark (reference
    train.py:196-228); a mesh only after 0.4 s of sim time."""
    cfg = trainer.cfg
    if cfg.save_checkpoints:
        from isdf_tpu_torch.utils import checkpoint as CK
        d = os.path.join(save_path, "checkpoints")
        os.makedirs(d, exist_ok=True)
        CK.save_checkpoint(os.path.join(d, f"step_{save_t}.ckpt"), trainer,
                           step=t)
    if cfg.save_slices:
        from isdf_tpu_torch.vis import slices as SL
        SL.write_slices(trainer, os.path.join(save_path, "slices"),
                        prefix=save_t + "_")
    if cfg.save_meshes and trainer.tot_step_time > 0.4:
        from isdf_tpu_torch.vis import mesh_export as ME
        d = os.path.join(save_path, "meshes")
        os.makedirs(d, exist_ok=True)
        ME.write_mesh(trainer, os.path.join(d, f"{save_t}.ply"))


def _refine_pose(trainer: Trainer):
    """Track the newly ingested frame: one burst of cfg.pose_iters
    iterations on it alone, folded into the arena (isdf_tpu
    loop.py:118-145). Settled keyframes are left alone. The burst is
    perception compute: the clock bills its measured time, or
    trainer._pose_burst_device_s where a run pins the clock."""
    cfg = trainer.cfg
    trainer.refine_poses_step(n_frames=1, n_steps=cfg.pose_iters)
    trainer.apply_pose_corrections()
    dt = trainer._pose_burst_device_s
    if dt is None:
        dt = max(trainer._last_burst_s, 1e-5)
    trainer.tot_step_time += dt / cfg.frac_time_perception
    trainer.step_timer.add("train", dt)


def train_loop(trainer: Trainer, max_steps: Optional[int] = None,
               max_time_s: Optional[float] = None, bundle: bool = True,
               extra_opt_steps: int = 400, save_path: Optional[str] = None,
               eval_hook: Optional[Callable[[Trainer], Dict]] = None,
               log_fn: Optional[Callable[[str], None]] = None) -> LoopResult:
    cfg = trainer.cfg
    size_dataset = len(trainer.dataset)
    max_steps = max_steps if max_steps is not None else cfg.n_steps
    do_timed_eval = cfg.do_eval or eval_hook is not None or cfg.mesh_eval
    res = {"sdf_eval": {}} if do_timed_eval else {}
    vox_res = {} if trainer.eval_times else None
    last_eval = 0.0
    break_at = -1
    tail_start = 0
    losses_last: Dict[str, float] = {}
    t = 0
    rounds = 0
    wall_t0 = time.perf_counter()
    # save marks every save_period sim-seconds for as long as the loop runs
    next_save = (cfg.save_period if save_path and cfg.save_period > 0
                 else float("inf"))

    while t < max_steps:
        if max_time_s is not None and trainer.tot_step_time > max_time_s:
            break
        # ---- frame ingestion / keyframe bookkeeping ----
        finish_optim = trainer.steps_since_frame == trainer.optim_frames
        if trainer.incremental and (finish_optim or t == 0):
            add_new_frame = True if t == 0 else trainer.check_keyframe_latest()
            if add_new_frame:
                new_frame_id = trainer.get_latest_frame_id()
                if new_frame_id >= size_dataset:
                    if break_at < 0:
                        break_at = t + extra_opt_steps
                        tail_start = t
                        # the output-noise regulariser only serves online
                        # exploration: anneal it off for the tail
                        trainer.noise_std = 0.0
                        trainer.tail_mode = cfg.tail_loss_window
                        if log_fn:
                            log_fn(f"end of sequence at step {t}; "
                                   f"running {extra_opt_steps} extra steps")
                else:
                    trainer.add_frame(trainer.get_data([new_frame_id])[0])
                    if t == 0:
                        trainer.last_is_keyframe = True
                        trainer.optim_frames = 200  # reference train.py:127
                    elif cfg.refine_poses and trainer.should_refine_pose():
                        _refine_pose(trainer)

        if t == break_at or (break_at > 0 and t > break_at):
            break

        # ---- optimisation ----
        budget = max(trainer.optim_frames - trainer.steps_since_frame, 1)
        if break_at > 0:
            budget = max(min(break_at - t, 100), 1)
            frac = min(max((t - tail_start) / max(extra_opt_steps, 1), 0.0),
                       1.0)
            lo = cfg.tail_lr_min
            trainer.lr_scale = lo + (1.0 - lo) * 0.5 * (
                1.0 + np.cos(np.pi * frac))
        if cfg.steps_per_bundle > 0:
            budget = min(budget, cfg.steps_per_bundle)
        n = min(budget if bundle else 1, max_steps - t)
        scalars = trainer.run_steps(n)
        losses_last = {k: float(v[-1]) for k, v in scalars.items()}
        t += n
        rounds += 1

        if log_fn and rounds % 10 == 0:
            msg = "  ".join(f"{k}: {v:.5f}" for k, v in losses_last.items())
            sps = trainer.perf_summary().get("steps_per_sec", 0.0)
            log_fn(f"step {t} t_sim={trainer.tot_step_time:.2f}s "
                   f"[{sps:.0f} steps/s] {msg}")

        # ---- save at sim-time marks (reference train.py:196-228) ----
        while trainer.tot_step_time > next_save:
            save_t = f"{next_save:.3f}"
            next_save += cfg.save_period
            _save_marks(trainer, save_path, save_t, t)

        # ---- the fixed-point eval (reference train.py:230-239), keyed by
        # its scheduled timestamp: one bundle can cross several ----
        while (trainer.eval_times
               and trainer.tot_step_time > trainer.eval_times[0]):
            t_sched = trainer.eval_times[0]
            vox_res[t_sched] = trainer.eval_fixed()
            if save_path:
                with open(os.path.join(save_path, "vox_res.json"), "w") as f:
                    json.dump(vox_res, f, indent=4)

        # ---- timed eval (reference train.py:241-279) ----
        if (do_timed_eval
                and trainer.tot_step_time - last_eval > cfg.eval_freq_s):
            last_eval = (trainer.tot_step_time
                         - trainer.tot_step_time % cfg.eval_freq_s)
            _te0 = time.perf_counter()
            entry = _timed_eval(trainer, eval_hook)
            if cfg.mesh_eval:
                _mesh_eval(trainer, res, t)
            trainer.step_timer.add("eval", time.perf_counter() - _te0)
            if entry:
                res["sdf_eval"][t] = {"time": trainer.tot_step_time, **entry}
            if save_path:
                with open(os.path.join(save_path, "res.json"), "w") as f:
                    json.dump(res, f, indent=4)

    # final eval of the settled model (the in-loop cadence can fire before
    # the refinement tail ends; the shipped state is what is scored)
    if do_timed_eval:
        _te0 = time.perf_counter()
        entry = _timed_eval(trainer, eval_hook)
        trainer.step_timer.add("eval", time.perf_counter() - _te0)
        if entry:
            res["sdf_eval"][t] = {"time": trainer.tot_step_time, **entry}
        if cfg.mesh_eval:
            _mesh_eval(trainer, res, t)

    kf_ids = [int(i) for i in trainer.frames.frame_ids[:-1]]
    if save_path and res:
        res["kf_indices"] = kf_ids
        with open(os.path.join(save_path, "res.json"), "w") as f:
            json.dump(res, f, indent=4)
    if save_path and vox_res:
        with open(os.path.join(save_path, "vox_res.json"), "w") as f:
            json.dump(vox_res, f, indent=4)

    return LoopResult(
        steps=t, rounds=rounds, sdf_evals=res.get("sdf_eval", {}),
        kf_indices=kf_ids, tot_step_time=trainer.tot_step_time,
        wall_time=time.perf_counter() - wall_t0, losses_last=losses_last)
