#!/usr/bin/env python
"""The port's spans in a ``train.py --trace`` run, held against the
Chrome trace it exports.

    python -m tools.span_check [--out DIR] [--small] [--cell NAME]
                                                        (from the repo's root)

Writes a ReplicaCAD-format sequence from a seed (benchmark/sequence.py),
trains on it with ``python -m isdf_tpu_torch.train.train --trace`` in this
process (checkpoints at save marks on, so the loop saves), then traces one
``SDFQueryEngine`` request of each kind and one ``MultiSceneStepper``
round under ``utils/profiling.device_trace``. For each trace it matches
every span the recorder kept (utils/profiling.recorded) to its
``isdf.<name>`` event in the exported ``trace.json``, and prints, per span
name, the count, the largest start and end differences in us and how many
pass 100 us. Each ``step.bundle`` span must name the train op it launched
on the card, its variant and lanes (``train_op``, "K1-ray/384"), with the
call's ``points``, ``embedding``, ``layers`` and ``surface`` and the
build's resident blocks an SM (``blocks_per_sm``); on the CPU (the plain
op) none names one. Exits 1 if a span of the lists below is
missing from its trace, a difference passes 100 us or a bundle's counts
are wrong. ``--small`` runs a 64 x 48 camera on the CPU (a rehearsal).
``--cell NAME`` checks, instead, a traced window of the benchmark's
training cell NAME (``benchmark/workloads``; e.g. realsense.steps): its
trainer set up as a run sets it up, five of its calls traced.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

import torch

# the spans each traced part must show
TRAIN = ("step.bundle", "step.table", "step.replay", "graphs.warm",
         "graphs.capture", "trainer.run_steps", "trainer.fetch",
         "loop.kf_check", "trainer.kf_fetch", "loop.ingest",
         "trainer.get_data", "trainer.normals", "trainer.add_frame",
         "buffer.upload", "loop.save", "data.frame", "data.file_read",
         "data.png_inflate", "data.png_unfilter", "data.depth_transform")
SERVE = ("serve.request", "serve.validate", "serve.lock", "serve.copy_in",
         "serve.compute", "serve.fetch", "fleet.round", "fleet.fetch",
         "step.bundle")
CELL = ("step.bundle", "step.table", "step.replay", "trainer.run_steps",
        "trainer.fetch")
TOL_US = 100.0
# a step.bundle's train_op on the card: K1's variant and lanes
VARIANT = re.compile(r"^K1-(pc|ray|stream)(-f32)?/(256|384)$")
SHAPE = ("points", "embedding", "layers", "surface")


def bundle_errors(spans, on_card: bool):
    """What is wrong with the ``step.bundle`` spans' counts: on the card
    each names its train op's variant and lanes and the call's shape; on
    the CPU none names one."""
    out = []
    for s in spans:
        if s.name != "step.bundle":
            continue
        c = s.counts
        if not on_card:
            if "train_op" in c:
                out.append(f"a CPU bundle names {c['train_op']}")
        elif not VARIANT.match(str(c.get("train_op", ""))):
            out.append(f"a bundle names no K1 variant: {c}")
        elif not all(isinstance(c.get(k), int) for k in SHAPE):
            out.append(f"a bundle lacks its op's shape: {c}")
        elif not (isinstance(c.get("blocks_per_sm"), int)
                  and c["blocks_per_sm"] >= 1):
            out.append(f"a bundle lacks its build's blocks an SM: {c}")
    return sorted(set(out))


def match(trace_path, spans):
    """{name: [count, largest |start gap|, largest |end gap|, count of
    spans with a gap past TOL_US]} of the recorder's spans against their
    events in the trace (us), and the names of spans that found no
    event."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("isdf."):
            by[e["name"][5:]].append((float(e["ts"]),
                                      float(e["ts"]) + float(e["dur"])))
    out, unmatched = {}, set()
    for s in spans:
        cands = by.get(s.name)
        if not cands:
            unmatched.add(s.name)
            continue
        a, b = min(cands, key=lambda c: abs(c[0] - s.t0))
        row = out.setdefault(s.name, [0, 0.0, 0.0, 0])
        row[0] += 1
        row[1] = max(row[1], abs(a - s.t0))
        row[2] = max(row[2], abs(b - s.t1))
        row[3] += max(abs(a - s.t0), abs(b - s.t1)) > TOL_US
    return out, sorted(unmatched)


def report(part, trace_dir, want, on_card):
    from isdf_tpu_torch.utils import profiling
    spans = profiling.recorded()
    rows, unmatched = match(os.path.join(trace_dir, "trace.json"), spans)
    missing = [n for n in want if n not in rows]
    worst = max((max(r[1], r[2]) for r in rows.values()), default=0.0)
    bad = bundle_errors(spans, on_card)
    variants = sorted({str(s.counts.get("train_op")) for s in spans
                       if s.name == "step.bundle"})
    blocks = sorted({str(s.counts.get("blocks_per_sm")) for s in spans
                     if s.name == "step.bundle"})
    print(f"{part}: {sum(r[0] for r in rows.values())} spans, worst "
          f"start/end gap {worst:.1f} us; dropped {profiling.dropped()}; "
          f"bundles' train_op {variants}, blocks_per_sm {blocks}")
    for b in bad:
        print(f"  {b}")
    for name, (n, ds, de, over) in sorted(rows.items()):
        print(f"  {name:22s} {n:6d}  start {ds:8.1f} us  end {de:8.1f} us"
              f"  past {TOL_US:.0f} us: {over}")
    if missing or unmatched:
        print(f"  missing: {missing}; without an event: {unmatched}")
    return {"part": part, "spans": rows, "missing": missing,
            "unmatched": unmatched, "worst_us": worst,
            "train_op": variants, "blocks_per_sm": blocks,
            "bundle_errors": bad,
            "ok": (not missing and not unmatched and worst <= TOL_US
                   and not bad)}


def cell_part(name, out, dev, small):
    """A traced window of the benchmark's training cell ``name``: its
    set-up as a run makes it (at a 64 x 48 camera with ``small``), a
    warm-up call, then five of its calls under the profiler."""
    import importlib
    import time
    from benchmark import common
    from benchmark.tests.test_bench_rehearsal import WIDE
    from isdf_tpu_torch.utils import profiling
    cell = common.cell_spec(name)
    ctx = common.Ctx(seed=7, seconds=0.0, trace=False, cell=cell,
                     device=dev, t_process=time.perf_counter(),
                     scratch=out, overrides=WIDE if small else {})
    traffic = importlib.import_module("benchmark.traffic." + cell["traffic"])
    _, _, prog = traffic._setup(ctx, ctx.config())
    obj, method = prog["call"]
    call = getattr(obj, method)
    bundle = int(ctx.params["bundle"])
    call(bundle)
    profiling.clear()
    trace = os.path.join(out, "cell_trace")
    with profiling.device_trace(trace):
        for _ in range(5):
            call(bundle)
    card = dev.type == "cuda"
    want = CELL if card else tuple(  # the CPU's steps run eagerly
        "step.eager" if n == "step.replay" else n for n in CELL)
    return report(f"{name} (a traced window)", trace, want, card)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cell", default=None)
    args = ap.parse_args(argv)
    from benchmark import common
    from benchmark import inputs as I
    from benchmark import sequence as SEQ
    from isdf_tpu_torch.parallel.multi_scene import MultiSceneStepper
    from isdf_tpu_torch.serve import SDFQueryEngine
    from isdf_tpu_torch.train import train as T
    from isdf_tpu_torch.utils import profiling

    out = args.out or tempfile.mkdtemp(prefix="span_check_")
    os.makedirs(out, exist_ok=True)
    dev = torch.device("cpu" if args.small else "cuda")
    if args.cell:
        results = [cell_part(args.cell, out, dev, args.small)]
        return finish(out, results)
    cfg = json.loads(json.dumps(
        common.cell_spec("replicacad.stream")["config_file"]["config"]))
    ds = cfg["dataset"]
    if args.small:
        ds["camera"] = {"w": 64, "h": 48, "fx": 32.0, "fy": 32.0,
                        "cx": 31.5, "cy": 23.5}
        cfg["sample"]["n_rays"] = 20
        cfg["tpu"]["kf_buffer_size"] = 8
        cfg["model"].update(iters_per_kf=6, iters_per_frame=3)
    c = ds["camera"]
    cam = dict(H=c["h"], W=c["w"], fx=c["fx"], fy=c["fy"], cx=c["cx"],
               cy=c["cy"])
    seq, gt, _, _ = SEQ.write(os.path.join(out, "data"), I.Room(7), 7, cam,
                              24, 600, float(ds["depth_scale"]), dev)
    ds.update(seq_dir=seq, gt_sdf_dir=gt)
    cfg["save"].update(save_checkpoints=1, save_period=0.25)
    path = os.path.join(out, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    steps = 60 if args.small else 600
    profiling.clear()
    trace1 = os.path.join(out, "train_trace")
    T.main(["--config", path, "--max_steps", str(steps), "--trace", trace1,
            "--save_path", os.path.join(out, "run"), "--seed", "7"]
           + (["--device", "cpu"] if args.small else []))
    results = [report("train.py --trace", trace1, TRAIN, not args.small)]

    # the serve engine and the multi-scene stepper on a trainer of the run
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    tr = Trainer(load_config(path), seed=7, device=dev)
    tr.add_frame(tr.get_data([0])[0])
    stepper = MultiSceneStepper([tr])
    stepper.run_steps(10)                       # warm-up and capture
    engine = SDFQueryEngine.from_trainer(tr)
    pts = I.query_points(7, 0, 4096 if args.small else 65536, I.Room(7))
    engine.sdf(pts), engine.grad(pts)
    profiling.clear()
    trace2 = os.path.join(out, "serve_trace")
    with profiling.device_trace(trace2):
        for _ in range(3):
            engine.sdf(pts)
            engine.grad(pts)
            stepper.run_steps(10)
    results.append(report("serve and fleet", trace2, SERVE,
                          not args.small))
    return finish(out, results)


def finish(out, results):
    with open(os.path.join(out, "span_check.json"), "w") as f:
        json.dump(results, f, indent=1)
    ok = all(r["ok"] for r in results)
    print(f"span_check: {'ok' if ok else 'FAILED'} (tolerance {TOL_US} us)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
