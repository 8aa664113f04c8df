"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON object on the
last line of standard output, and the numbers compared with their limits
as the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA cards, or if JAX or the JAX package was loaded.

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs
the window under torch.profiler with the benchmark's host spans and
reports its per-layer metrics and the trace's breakdown.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from benchmark import common  # noqa: E402

# the program's kernel builds live at a fixed path inside the checkout, so
# that only a checkout's first run builds them
BUILD_DIR = os.path.join(common.ROOT, ".bench_cache", "build")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, overrides=None, t_process=None) -> int:
    """One run. ``device`` and ``overrides`` serve the CPU rehearsals
    (benchmark/tests): a device other than the card, shrunken sizes."""
    args = parse(argv)
    cell = common.cell_spec(args.workload)
    os.environ["ISDF_TORCH_BUILD_DIR"] = BUILD_DIR
    import torch
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
                  f"card(s), {have} visible; no result", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    import importlib
    traffic = importlib.import_module("benchmark.traffic." + cell["traffic"])
    scratch = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = common.Ctx(seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), cell=cell, device=device,
                         t_process=T_PROCESS if t_process is None
                         else t_process,
                         scratch=scratch, overrides=overrides or {})
        out = traffic.run(ctx)
        bad = common.loaded_forbidden()
        if bad:
            print("benchmark: JAX or the JAX package was loaded: "
                  + ", ".join(bad) + "; no result", file=sys.stderr)
            return 3
        res = common.result_line(ctx, out)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"run: {time.perf_counter() - ctx.t_process:.3f} s from the "
          f"process's start", file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr)
    for name, v, lim in out.checks:
        print(f"compared {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
