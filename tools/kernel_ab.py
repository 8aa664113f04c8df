#!/usr/bin/env python
"""Parent against change on one card: chip_smoke.py's kernel phase and the
f32 trainer's profile, each in the order parent, change, change, parent.

    python3 tools/kernel_ab.py PARENT_DIR [--out DIR]   (from the repo's root)
    python3 tools/kernel_ab.py --tree DIR               (one kernel run)

PARENT_DIR holds the parent commit, unpacked by git archive into a
directory that .gitignore lists. A kernel run imports one tree's
chip_smoke.py and package and runs its phase 2 (the builds, every kernel
held against its plain version, the timings), with this tree's timing
instrument (chip_smoke.traced_kernels and device_ms) in place of the
tree's own, so that both trees are timed alike. A profile run is
``python -m isdf_tpu_torch.train.profile_step tpu.mm_precision=highest``
in the tree. Each run's output goes to DIR (default results/kernel_ab); the
last lines give, per kernel, every run's device ms by tree, and per tree
the f32 trainer's kernel ms, kernels and idle share a step.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE = ("-m", "isdf_tpu_torch.train.profile_step",
           "tpu.mm_precision=highest")


def run_tree(tree):
    """One tree's kernel phase, timed by this tree's instrument."""
    import torch
    tree = os.path.abspath(tree)
    spec = importlib.util.spec_from_file_location(
        "instrument", os.path.join(ROOT, "chip_smoke.py"))
    inst = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(inst)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from isdf_tpu_torch.utils import nvcc
    for mod in (cs, nvcc):
        assert os.path.abspath(mod.__file__).startswith(tree + os.sep), mod
    assert cs.KERNEL_NAMES == inst.KERNEL_NAMES
    cs.traced_kernels, cs.device_ms = inst.traced_kernels, inst.device_ms
    print(f"tree {tree}; card: {cs.card_line()}", flush=True)
    nvcc.load_all(cs.SOURCES)
    s = cs.Setup(torch)
    rows = [cs.check(torch, s, name) for name in cs.REPLACES]
    print(json.dumps({"kernels": rows}))


def _run(cmd, cwd, log):
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                            timeout=900).returncode
        f.write(f"rc={rc}\n")
    print(f"{os.path.basename(log)}: rc={rc}", flush=True)
    return rc


def _kernel_rows(log):
    with open(log) as f:
        for line in reversed(f.read().splitlines()):
            if line.startswith('{"kernels"'):
                return json.loads(line)["kernels"]
    return []


def _profile(log):
    with open(log) as f:
        text = f.read()
    m = re.search(r"([\d.]+) ms per scene-step; kernels: [\d.]+ per round, "
                  r"([\d.]+) per scene-step", text)
    idle = re.search(r"idle share: ([\d.]+)", text)
    bare = re.search(r"host wall, bare: [\d.]+ ms per round, ([\d.]+) ms",
                     text)
    if not (m and idle and bare):
        return None
    return dict(kernel_ms=float(m.group(1)), kernels=float(m.group(2)),
                idle=float(idle.group(1)), host_ms_bare=float(bare.group(1)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", nargs="?")
    parser.add_argument("--tree")
    parser.add_argument("--out", default=os.path.join(ROOT, "results",
                                                      "kernel_ab"))
    args = parser.parse_args()
    if args.tree:
        run_tree(args.tree)
        return
    parent = os.path.abspath(args.parent)
    os.makedirs(args.out, exist_ok=True)
    order = (("P", parent), ("C", ROOT), ("C", ROOT), ("P", parent))
    rcs, kernels, profiles = [], {}, {"P": [], "C": []}
    for i, (tag, tree) in enumerate(order, 1):
        log = os.path.join(args.out, f"kern_{i}_{tag}.log")
        rcs.append(_run([sys.executable, os.path.abspath(__file__), "--tree",
                         tree], ROOT, log))
        for row in _kernel_rows(log):
            kernels.setdefault(row["name"], {"P": [], "C": []})[tag].append(
                dict(ms=row["ms"], parts=row.get("parts", {})))
    for i, (tag, tree) in enumerate(order, 1):
        log = os.path.join(args.out, f"prof_{i}_{tag}.log")
        rcs.append(_run([sys.executable, *PROFILE], tree, log))
        profiles[tag].append(_profile(log))
    for name, by in kernels.items():
        print(f"{name}: parent " + ", ".join(f"{r['ms']:.4f}" for r in by["P"])
              + "; change " + ", ".join(f"{r['ms']:.4f}" for r in by["C"]),
              flush=True)
    for tag in ("P", "C"):
        print(f"profile_step {PROFILE[2]} [{tag}]: {json.dumps(profiles[tag])}")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(dict(rcs=rcs, kernels=kernels, profiles=profiles), f,
                  indent=1)
    print(f"rcs {rcs}")
    sys.exit(0 if all(rc == 0 for rc in rcs) else 1)


if __name__ == "__main__":
    main()
