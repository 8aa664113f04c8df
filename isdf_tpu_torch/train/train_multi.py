#!/usr/bin/env python
"""Multi-scene training CLI of the port (isdf_tpu/train/train_multi.py): K
scenes on one card.

    python -m isdf_tpu_torch.train.train_multi \
        --config sceneA.json --config sceneB.json [--save_path DIR] \
        [--max_steps N] [--max_time_s T] [--seed S] [--extra_opt_steps N] \
        [--set SECTION.KEY=VALUE] [--device cuda|cpu]

The reference maps one scene per process per GPU (isdf/train/
train.py:282-358); this CLI time-shares one card across K independent
scenes in lockstep (parallel/multi_scene.py). Each scene has its own
config, dataset, seed (``--seed`` + its index) and keyframe state machine;
the simulated clock bills every scene the whole round's device time, so a
run keeps real time only if each scene's step rate still clears its
sequence's budget. Runs on the CUDA device unless ``--device cpu``.

Writes, per scene, ``<save_path>/scene_<i>/``: the scene's config.json, a
res.json with the loop's summary and the final visible-region SDF eval
(eval/protocol.py, "rays", as the single-scene loop's last entry) where
eval.do_eval is set and a GT SDF exists, and final.ckpt, the full-state
checkpoint (utils/checkpoint.py) that serve.py and train.py
--load_checkpoint read.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="isdf_tpu_torch multi-scene trainer")
    parser.add_argument("--config", action="append", required=True,
                        dest="configs", metavar="CFG.json",
                        help="one per scene (repeat); scenes must share "
                             "the step's configuration (camera, model, "
                             "ray and sample counts: parallel/"
                             "multi_scene._HOT_FIELDS)")
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--max_time_s", type=float, default=None,
                        help="stop once every scene's simulated clock "
                             "passes this (the clocks are billed together)")
    parser.add_argument("--seed", type=int, default=1,
                        help="scene i trains with seed + i")
    parser.add_argument("--extra_opt_steps", type=int, default=400)
    parser.add_argument("--set", action="append", dest="overrides",
                        metavar="SECTION.KEY=VALUE",
                        help="override a config entry in every scene "
                             "(repeatable)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.eval.protocol import eval_sdf
    from isdf_tpu_torch.parallel import multi_scene as MS
    from isdf_tpu_torch.utils.checkpoint import save_checkpoint
    from isdf_tpu_torch.utils.config import load_config

    trainers = []
    for i, path in enumerate(args.configs):
        cfg = load_config(path, overrides=args.overrides)
        trainers.append(Trainer(cfg, seed=args.seed + i, device=args.device))
        if args.save_path:
            sdir = os.path.join(args.save_path, f"scene_{i}")
            os.makedirs(sdir, exist_ok=True)
            with open(os.path.join(sdir, "config.json"), "w") as f:
                with open(path) as src:
                    json.dump(json.load(src), f, indent=4)

    out = MS.multi_scene_loop(
        trainers, max_steps=args.max_steps, max_time_s=args.max_time_s,
        extra_opt_steps=args.extra_opt_steps,
        log_fn=lambda m: print(m, flush=True))

    for i, tr in enumerate(trainers):
        summary = dict(out[i])
        msg = (f"scene {i}: {out[i]['steps']} steps, "
               f"t_sim={tr.tot_step_time:.1f}s")
        if tr.cfg.do_eval and tr.gt_sdf_fn is not None:
            ev = eval_sdf(tr, visible_region=True,
                          seed=int(tr.tot_step_time * 1e3))
            summary["sdf_eval"] = {out[i]["steps"]: {
                "time": tr.tot_step_time, "rays": ev}}
            msg += f", visible MAE {ev['av_l1'] * 100:.2f} cm"
        print(msg, flush=True)
        if args.save_path:
            sdir = os.path.join(args.save_path, f"scene_{i}")
            with open(os.path.join(sdir, "res.json"), "w") as f:
                json.dump(summary, f, indent=4)
            save_checkpoint(os.path.join(sdir, "final.ckpt"), tr,
                            step=out[i]["steps"])
    return out


if __name__ == "__main__":
    main()
