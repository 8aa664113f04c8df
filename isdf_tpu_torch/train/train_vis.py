#!/usr/bin/env python
"""Training with visual monitoring (isdf_tpu/train/train_vis.py; reference
isdf/train/train_vis.py):

    python -m isdf_tpu_torch.train.train_vis --config cfg.json \
        --save_path out/ [--monitor_every_s 2.0] [--max_steps N] \
        [--max_time_s T] [--seed S] [--trace DIR] [--serve PORT] \
        [--serve-queries PORT] [--set SECTION.KEY=VALUE] [--device cuda|cpu]

The reference drives an Open3D GUI; this entry point runs the training
loop and, every ``--monitor_every_s`` seconds of simulated time, writes
the GUI's content as images into <save_path>/monitor/: the keyframe
strip, the latest-frame panel (rgb / depth beside the rendered normals /
depth, with the compute balance) and two SDF slices; at the end a mesh
turntable in monitor/final_mesh/. The monitor's seconds are billed to the
"vis" share of the compute balance, not to the simulated clock; it draws
no random number from the trainer's generators, so the training is the
same with or without it. Runs on the CUDA device unless ``--device cpu``.
``--serve-queries`` serves the planner query API (serve.py), refreshed
each monitor cycle. ``--serve`` serves the interactive viewer
(vis/server.py) beside the run: its controls pause the loop, cap its
bundles and gate the monitor's parts ("do_mesh": the keyframe strip and
latest render, "do_slices": the slices); its snapshot refreshes on the
loop's thread, in a monitor cycle or while paused, only when a browser
asked or looked since the last one.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time


def make_hook(mon_dir: str, every_s: float, qsrv=None, times=None,
              web=None):
    """The loop's eval hook: a monitor cycle whenever ``every_s`` seconds
    of simulated time have passed since the last. ``times``: a dict that
    gets the seconds of the cycles' parts (the keyframe strip and latest
    render "latest", their PNG writes "write", the slices "slices", the
    viewer's refreshes "refresh") and their count ("cycles"). ``web``: the
    SDFWebViewer, whose controls gate the parts."""
    from isdf_tpu_torch.vis import slices as SL
    from isdf_tpu_torch.vis import viewer as V

    state = {"last": -1e9, "i": 0}
    times = {} if times is None else times

    def hook(tr):
        if tr.tot_step_time - state["last"] >= every_s:
            t0 = time.perf_counter()
            state["last"] = tr.tot_step_time
            tag = f"{state['i']:04d}_"
            state["i"] += 1
            # the viewer's content toggles (reference isdf_window.py's mesh
            # and slices checkboxes) skip the work itself
            ctl = (web.source.get_controls() if web is not None
                   else {"do_mesh": True, "do_slices": True})
            if ctl["do_mesh"]:
                V.monitor(tr, mon_dir, tag=tag, times=times)
            t1 = time.perf_counter()
            if ctl["do_slices"]:
                SL.write_slices(tr, mon_dir, prefix=tag, n_slices=2,
                                include_gt=tr.gt_sdf_fn is not None)
            times["slices"] = times.get("slices", 0.0) + (
                time.perf_counter() - t1)
            if web is not None:
                t1 = time.perf_counter()
                web.source.refresh_if_watched()
                times["refresh"] = times.get("refresh", 0.0) + (
                    time.perf_counter() - t1)
            if qsrv is not None:
                qsrv.engine.refresh_from_trainer(tr)
            times["cycles"] = times.get("cycles", 0) + 1
            # the reference GUI's 20-s train-vs-vis compute balance
            # (isdf_window.py:694-708)
            tr.step_timer.add("vis", time.perf_counter() - t0)
        return {}

    return hook


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--save_path", "--out", dest="save_path", type=str,
                    default="results/monitor_run")
    ap.add_argument("--monitor_every_s", type=float, default=2.0)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--max_time_s", type=float, default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler trace to this directory")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="also serve the interactive viewer "
                         "(vis/server.py) on this port; the SDF "
                         "snapshot refreshes each monitor cycle")
    ap.add_argument("--serve-queries", type=int, default=None,
                    metavar="PORT",
                    help="also serve the planner query API (serve.py: "
                         "POST /sdf /grad /query /collision) on this "
                         "port; the served map snapshot refreshes each "
                         "monitor cycle")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="SECTION.KEY=VALUE",
                    help="override a config entry (repeatable)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    from isdf_tpu_torch.utils.profiling import device_trace
    from isdf_tpu_torch.vis import viewer as V

    trainer = Trainer(load_config(args.config, overrides=args.overrides),
                      seed=args.seed, device=args.device)
    mon_dir = os.path.join(args.save_path, "monitor")
    os.makedirs(mon_dir, exist_ok=True)

    web = qsrv = control_hook = None
    try:
        if args.serve is not None:
            from isdf_tpu_torch.vis.server import SDFWebViewer, ViewerSource
            web = SDFWebViewer(
                ViewerSource.from_trainer(trainer, loop_attached=True),
                port=args.serve).start()
            print(f"interactive viewer: http://127.0.0.1:{web.port}",
                  flush=True)

            def control_hook():
                c = web.source.get_controls()
                if c.get("paused"):
                    # paused, the loop's thread is free to refresh
                    web.source.refresh_if_watched()
                return c
        if args.serve_queries is not None:
            from isdf_tpu_torch.serve import SDFQueryEngine, SDFQueryServer
            qsrv = SDFQueryServer(SDFQueryEngine.from_trainer(trainer),
                                  port=args.serve_queries).start()
            print(f"query API: http://127.0.0.1:{qsrv.port}", flush=True)

        hook = make_hook(mon_dir, args.monitor_every_s, qsrv, web=web)
        ctx = (device_trace(args.trace) if args.trace
               else contextlib.nullcontext())
        with ctx:
            res = train_loop(trainer, max_steps=args.max_steps,
                             max_time_s=args.max_time_s,
                             save_path=args.save_path, eval_hook=hook,
                             control_hook=control_hook,
                             log_fn=lambda m: print(m, flush=True))
    finally:
        for srv in (web, qsrv):
            if srv is not None:
                srv.stop()
    bal = trainer.perf_summary()
    print("compute balance (20s window): " + ", ".join(
        f"{k}={v:.2f}" for k, v in bal.items()), flush=True)
    V.mesh_turntable(trainer, os.path.join(mon_dir, "final_mesh"))
    print(f"done: {res.steps} steps, monitor frames in {mon_dir}",
          flush=True)
    return res


if __name__ == "__main__":
    main()
