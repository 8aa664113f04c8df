#!/usr/bin/env python
"""Training CLI of the port (isdf_tpu/train/train.py):

    python -m isdf_tpu_torch.train.train --config cfg.json [-ni] [-hd] \
        [--save_path DIR | --save] [--max_steps N] [--max_time_s T] \
        [--seed S] [--grid_dim D] [--per_step] [--trace DIR] \
        [--sim_dt DT] [--load_checkpoint PATH] [--set SECTION.KEY=VALUE] \
        [--device cuda|cpu|DEV,DEV,...]

Runs on the CUDA device unless ``--device cpu``. With
``--set tpu.data_parallel=N`` the step is sharded over N devices
(engine/trainer.py): the first N cards, N CPU shards with ``--device cpu``,
or the N devices of a comma-separated list (``cuda:0,cuda:0``: two shards
on one card). ``-ni`` is the batch
(non-incremental) mode, ``--per_step`` the reference's one-step loop,
``--trace`` writes a torch.profiler trace of the run. With eval.do_eval the
reference protocol scores the visible region against the GT SDF into
res.json ("rays"). ``--load_checkpoint`` resumes from a full-state .npz
(either package's) or loads the weights of a reference torch .pth; the
save section writes checkpoints, SDF slices and meshes under the save path
at sim-time marks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from datetime import datetime


def main(argv=None):
    parser = argparse.ArgumentParser(description="isdf_tpu_torch trainer")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("-ni", "--no_incremental", action="store_false",
                        dest="incremental",
                        help="batch mode: train on the chosen views, no "
                             "ingestion")
    parser.add_argument("-hd", "--headless", action="store_true",
                        help="accepted for reference-CLI parity (runs are "
                             "headless regardless)")
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--save", action="store_true",
                        help="save to results/isdf_tpu_torch/<timestamp>")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--max_time_s", type=float, default=None,
                        help="stop after this much simulated time")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--load_checkpoint", type=str, default=None,
                        help=".npz full-state checkpoint or a reference "
                             "torch .pth (weights only)")
    parser.add_argument("--grid_dim", type=int, default=200)
    parser.add_argument("--per_step", action="store_true",
                        help="reference-exact per-step loop (no bundling)")
    parser.add_argument("--trace", type=str, default=None,
                        help="write a torch.profiler trace to this "
                             "directory")
    parser.add_argument("--sim_dt", type=float, default=None,
                        help="bill the simulated clock a FIXED dt seconds "
                             "per step instead of measured device time")
    parser.add_argument("--set", action="append", dest="overrides",
                        metavar="SECTION.KEY=VALUE",
                        help="override a config entry (repeatable)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default), cpu, or a comma-separated "
                             "list, the tpu.data_parallel mesh")
    args = parser.parse_args(argv)

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.parallel.mesh import parse_devices
    from isdf_tpu_torch.utils.config import load_config
    from isdf_tpu_torch.utils.profiling import device_trace

    cfg = load_config(args.config, overrides=args.overrides)
    save_path = args.save_path
    if args.save and save_path is None:
        stamp = datetime.now().strftime("%m-%d-%y_%H-%M-%S")
        save_path = os.path.join("results", "isdf_tpu_torch", stamp)
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "config.json"), "w") as f:
            with open(args.config) as src:
                json.dump(json.load(src), f, indent=4)

    trainer = Trainer(cfg, incremental=args.incremental,
                      grid_dim=args.grid_dim, seed=args.seed,
                      device=parse_devices(args.device))
    if args.sim_dt is not None:
        trainer._per_step_device_s = args.sim_dt
    if args.load_checkpoint:
        trainer.load_checkpoint(args.load_checkpoint)
    ctx = (device_trace(args.trace) if args.trace
           else contextlib.nullcontext())
    with ctx:
        res = train_loop(trainer, max_steps=args.max_steps,
                         max_time_s=args.max_time_s,
                         bundle=not args.per_step, save_path=save_path,
                         log_fn=lambda m: print(m, flush=True))
    print(f"done: {res.steps} steps in {res.wall_time:.1f}s wall "
          f"({res.tot_step_time:.1f}s simulated), "
          f"{len(res.kf_indices) + 1} keyframes", flush=True)
    return res


if __name__ == "__main__":
    main()
