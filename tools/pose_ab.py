#!/usr/bin/env python
"""What the pose tracker (model.refine_poses) does to the arena's poses on
the card.

    python -m tools.pose_ab [NOISE:STEPS ...]     (from the repo's root)

For each random-walk pose noise std and step count (default 0.006:1200
0.008:1200 0.01:1200 0.01:1800 0.01:2400), runs the trainer on the
shipped synthetic.json with and without model.refine_poses, the clock
pinned at 1/300 s a step and the bursts unbilled (both arms ingest frames
on one schedule), and prints one JSON line per run with the arena's pose
errors against the GT poses and the same frames' reported (noisy) poses:
the mean absolute translation error, the same after fixing the gauge at
the first keyframe, the relative pose error of consecutive keyframes and
the ATE after a rigid (Umeyama) alignment. Then isdf_tpu's anchored
tracking test at full width (tests/test_engine.py:284-336: a map trained
450 steps on frame 0 at its true pose, frame 1 or 2 with iid noise of
std 0.03, one 60-iteration burst) for two seeds: the misposed frame's
error before and after.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                      "synthetic.json")
DEFAULT = ("0.006:1200", "0.008:1200", "0.01:1200", "0.01:1800",
           "0.01:2400")


def _inv(T):
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _ate(P, Q):
    """RMS position error after the rigid alignment of P onto Q."""
    mp, mq = P.mean(0), Q.mean(0)
    U, _, Vt = np.linalg.svd((Q - mq).T @ (P - mp))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    return float(np.sqrt(((P @ R.T + (mq - mp @ R.T) - Q) ** 2)
                         .sum(1).mean()))


def errors(A, G):
    """Pose errors of poses A [n, 4, 4] against G [n, 4, 4]."""
    n = len(A)
    rel = [_inv(A[0]) @ A[i] for i in range(n)]
    relg = [_inv(G[0]) @ G[i] for i in range(n)]
    rpe = [np.linalg.norm((_inv(A[i - 1]) @ A[i])[:3, 3]
                          - (_inv(G[i - 1]) @ G[i])[:3, 3])
           for i in range(1, n)]
    return dict(
        abs=float(np.linalg.norm(A[:, :3, 3] - G[:, :3, 3], axis=1).mean()),
        gauge=float(np.mean([np.linalg.norm(rel[i][:3, 3] - relg[i][:3, 3])
                             for i in range(n)])),
        rpe=float(np.mean(rpe)) if rpe else 0.0,
        ate=_ate(A[:, :3, 3], G[:, :3, 3]))


def walk_run(noise, refine, steps):
    import torch

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, overrides=[
        f"dataset.pose_noise_std={noise}", "dataset.pose_noise_mode=walk",
        f"model.refine_poses={refine}"])
    tr = Trainer(cfg, seed=1)
    tr._per_step_device_s, tr._bill_exact = 1.0 / 300, True
    tr._pose_burst_device_s = 0.0
    train_loop(tr, max_steps=steps)
    ds = tr.dataset
    n = tr.buffer.count
    fids = [int(f) for f in tr.buffer.frame_id[:n].cpu().numpy()]
    T = tr.buffer.T_WC[:n].cpu().numpy().astype(np.float64)
    G = np.stack([ds.poses[f] for f in fids]).astype(np.float64)
    N = np.stack([ds.noisy_poses[f] for f in fids]).astype(np.float64)
    print(json.dumps(dict(noise=noise, steps=steps, refine=refine,
                          frames=fids, arena=errors(T, G),
                          reported=errors(N, G))), flush=True)
    del tr
    torch.cuda.empty_cache()


def anchored(seed):
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, overrides=[
        "dataset.pose_noise_std=0.03", "dataset.pose_noise_mode=iid",
        "model.refine_poses=1", "pose_refine.min_rel_improve=0.05"])
    tr = Trainer(cfg, seed=seed)
    ds = tr.dataset
    tr.last_is_keyframe = True
    tr.add_frame(dataclasses.replace(tr.get_data([0])[0], T_WC=ds.poses[0]))
    for _ in range(15):
        tr.run_steps(30)
    f = 1 + seed
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([f])[0])
    err0 = float(np.abs(tr.buffer.T_WC[1].cpu().numpy() - ds.poses[f]).max())
    tr.refine_poses_step(n_steps=60)
    tr.apply_pose_corrections()
    err1 = float(np.abs(tr.buffer.T_WC[1].cpu().numpy() - ds.poses[f]).max())
    print(json.dumps(dict(anchored_seed=seed, frame=f, err_before=err0,
                          err_after=err1,
                          burst_ms=1e3 * tr._last_burst_s)), flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        sys.exit("tools.pose_ab: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    for spec in argv or DEFAULT:
        noise, steps = spec.split(":")
        for refine in (0, 1):
            walk_run(float(noise), refine, int(steps))
    for seed in (0, 1):
        anchored(seed)


if __name__ == "__main__":
    main(sys.argv[1:])
