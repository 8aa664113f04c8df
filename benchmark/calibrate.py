"""The readings that the limits of ``correct`` are set from:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        [--controls 1]

For each seed it sets a cell up as a run does and prints one JSON line of
its compared numbers: the program's, and with ``--controls 1`` those of
the reference put in the program's place one precision below the stated
one (the control: float8 operands for bf16, TF32 for float32) and of the
faults a cell can have (training: half of each batch left out; queries:
an answer altered where it is produced). A step that leaves its state
unchanged reads 1 on the change and gradient numbers by their definition
and needs no run. No window is timed: the training readings come from the
compared steps of the cell's own set-up, the query readings from one
request of each kind per point set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _train(ctx, controls):
    """The set-up of the cell's traffic kind, its compared steps included,
    then the readings."""
    import importlib
    from benchmark import trainers as TR
    cfg = ctx.config()
    traffic = importlib.import_module("benchmark.traffic."
                                      + ctx.cell["traffic"])
    scenes, firsts, prog = traffic._setup(ctx, cfg)
    prog.clear()
    for s in scenes:
        s.trainer = None
    out = {}
    runs = [("program", None, False)]
    if controls:
        runs += [("control_fp8", "fp8", False),
                 ("half_batch", TR.stated_precision(cfg), True)]
    for name, prec, half in runs:
        worst = {}
        for s, fs in zip(scenes, firsts):
            if prec is not None:
                fs = TR.ref_first_steps(ctx, s, cfg, prec, half)
            for k, v in TR.compare(ctx, s, cfg, fs).items():
                worst[k] = max(worst.get(k, 0.0), v)
        out[name] = worst
    apart = []
    for s, fs in zip(scenes, firsts):
        ref = TR._ref(ctx, s, cfg, TR.stated_precision(cfg), False)
        ref.step(0)
        apart.append(ref.rays_apart(1, *fs.prio1))
    out["step2_rays_apart"] = apart
    return out


def _stream(ctx, controls):
    """A run with a window of no length: the loop up to the compared
    steps at the window's graph key, then the reference."""
    import dataclasses
    from benchmark import common
    from benchmark import trainers as TR
    from benchmark.traffic import stream as ST
    # a sequence as long as a timed run's
    lead = float(ctx.params["lead_s"]) + float(common.load_json(
        os.path.join(common.ROOT, "BENCHMARK.json"))["run_seconds"])
    ctx = dataclasses.replace(ctx, overrides={
        **ctx.overrides,
        "params": {**ctx.overrides.get("params", {}), "lead_s": lead}})
    keep = {}
    ST.run(ctx, keep)
    out = {"program": keep["vals"]}
    if controls:
        cfg = ctx.config()
        prec = TR.stated_precision(cfg)
        for name, got in (
                ("control_fp8", keep["reference"]("fp8")),
                ("half_batch", keep["reference"](prec, half_batch=True))):
            fs = TR.readings(got)
            out[name] = TR.REF.compare_first_steps(
                keep["reference"](prec), fs.losses, fs.grad0, fs.delta)
    return out


def _query(ctx, controls):
    import numpy as np
    import torch
    from benchmark import inputs as I
    from benchmark import reference as REF
    from benchmark.traffic import query as Q
    cfg = ctx.config()
    p = ctx.params
    mp = REF.Map(cfg)
    n = int(p["points"])
    room = I.Room(ctx.seed)
    layers = I.make_weights(ctx.seed, mp.E, mp.H, mp.blocks, ctx.device)
    pool = [I.query_points(ctx.seed, i, n, room)
            for i in range(int(p["distinct"]))]
    engine = Q.make_engine(ctx, cfg, layers, room)
    kept = [(i, g, (engine.grad if g else engine.sdf)(pool[i]))
            for i in range(len(pool)) for g in (False, True)]
    out = {"program": dict(zip(("sdf_gap", "grad_gap"), Q.gaps(
        ctx, cfg, layers, room, pool, kept, "f32")))}
    if controls:
        T = torch.as_tensor(
            np.linalg.inv(room.bounds_transform()).astype(np.float32),
            device=ctx.device)
        ctl = []
        for i, g, _ in kept:
            x = torch.as_tensor(pool[i], device=ctx.device)
            if g:
                r = REF.sdf_and_grad(layers, x, T, mp, "tf32")[1]
            else:
                r = REF.sdf(layers, x, T, mp, "tf32").detach()
            ctl.append((i, g, r.cpu().numpy()))
        out["control_tf32"] = dict(zip(("sdf_gap", "grad_gap"), Q.gaps(
            ctx, cfg, layers, room, pool, ctl, "f32")))
        alt = []
        for i, g, o in kept:
            o = o.copy()
            o.reshape(-1)[0] += 1e-3 * float(np.abs(o).max())
            alt.append((i, g, o))
        out["altered_answer"] = dict(zip(("sdf_gap", "grad_gap"), Q.gaps(
            ctx, cfg, layers, room, pool, alt, "f32")))
    return out


def main(argv=None, device=None, overrides=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=0)
    args = ap.parse_args(argv)
    from benchmark import common, run
    os.environ["ISDF_TORCH_BUILD_DIR"] = run.BUILD_DIR
    import torch
    cell = common.cell_spec(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark.calibrate: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    kind = {"query": _query, "stream": _stream}.get(cell["traffic"], _train)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bench_") as d:
            ov = dict(overrides or {})
            # no run-in: nothing is timed
            ov["params"] = {**ov.get("params", {}), "warm_s": 0}
            ctx = common.Ctx(seed=seed, seconds=0.0, trace=False, cell=cell,
                             device=device, t_process=t, scratch=d,
                             overrides=ov)
            row = {"workload": args.workload, "seed": seed,
                   **kind(ctx, bool(args.controls)),
                   "seconds": time.perf_counter() - t}
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
