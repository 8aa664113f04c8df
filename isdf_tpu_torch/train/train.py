#!/usr/bin/env python
"""Training CLI of the port (isdf_tpu/train/train.py):

    python -m isdf_tpu_torch.train.train --config cfg.json \
        [--save_path DIR] [--max_steps N] [--max_time_s T] [--seed S] \
        [--sim_dt DT] [--set SECTION.KEY=VALUE] [--device cuda|cpu]

Runs on the CUDA device unless ``--device cpu``. A config with
eval.do_eval on a synthetic scene is scored against the scene's analytic
SDF (mean |error| over fixed random points in the room); other evals,
checkpoints, slices, meshes and pose refinement are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="isdf_tpu_torch trainer")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--max_time_s", type=float, default=None,
                        help="stop after this much simulated time")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--sim_dt", type=float, default=None,
                        help="bill the simulated clock a FIXED dt seconds "
                             "per step instead of measured device time")
    parser.add_argument("--set", action="append", dest="overrides",
                        metavar="SECTION.KEY=VALUE",
                        help="override a config entry (repeatable)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, overrides=args.overrides)
    if args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        with open(os.path.join(args.save_path, "config.json"), "w") as f:
            with open(args.config) as src:
                json.dump(json.load(src), f, indent=4)

    trainer = Trainer(cfg, seed=args.seed, device=args.device)
    if args.sim_dt is not None:
        trainer._per_step_device_s = args.sim_dt
        trainer._bill_exact = True
    eval_hook = None
    if cfg.do_eval:
        if not hasattr(trainer.dataset, "sdf_mae"):
            raise NotImplementedError(
                "eval.do_eval is ported for synthetic scenes only")
        eval_hook = lambda tr: {"sdf_mae": tr.dataset.sdf_mae(tr.sdf_fn)}
    res = train_loop(trainer, max_steps=args.max_steps,
                     max_time_s=args.max_time_s, save_path=args.save_path,
                     eval_hook=eval_hook,
                     log_fn=lambda m: print(m, flush=True))
    print(f"done: {res.steps} steps in {res.wall_time:.1f}s wall "
          f"({res.tot_step_time:.1f}s simulated), "
          f"{len(res.kf_indices) + 1} keyframes", flush=True)
    return res


if __name__ == "__main__":
    main()
