#!/usr/bin/env python
"""Where the nearest-surface kernel (K4) spends its time on the card.

    python -m tools.k4_probe [NAME ...]     (from the repo's root)

On chip_smoke.py's trainer-shaped inputs (M = 27,000 points, the strided
surface set pc[:, 0] of R = 1,000 points, 90% valid), prints:

  * K4's device ms (torch.profiler trace over 50 calls) as R is swept at
    the same M: its fixed part and its cost per 1,000 surface rows;
  * the SM clock while K4 runs back to back (nvidia-smi);
  * the instructions of the scan loop of the kernel as shipped (ppt 7),
    from cuobjdump's SASS: the shortest backward branch whose body holds
    the run's eight LDS.128 loads of staged rows;
  * variants of csrc/bounds_pc.cu (VARIANTS, text edits in a copy of
    csrc/, all built at once), timed in turns "shipped, variants..."
    twice, each with whether its indices equal the plain version's. Some
    variants compute the wrong thing on purpose, to time one part alone
    (the scan without its selection, the kernel without its scan).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
import time

import torch

SCORE = """  return __fadd_rn(q.w, __fadd_rn(__fadd_rn(__fmul_rn(x, q.x),
                                            __fmul_rn(y, q.y)),
                                  __fmul_rn(z, q.z)));"""
MIN = "          m[j] = fminf(m[j], k4_score(x[j], y[j], z[j], q));"
NO_SCAN = ("    for (; k + K4_RUN <= ke; k += K4_RUN) {",
           "    for (k = ke; k + K4_RUN <= ke; k += K4_RUN) {")
# name -> [(text, replacement)] in bounds_pc.cu (every occurrence)
VARIANTS = {
    # the score as three fused multiply-adds (other bits: timing only)
    "fma score": [(SCORE, "  return fmaf(z, q.z, fmaf(y, q.y, fmaf(x, q.x, "
                          "q.w)));")],
    # the running minimum as a sum (no selection: timing only)
    "fadd for fminf": [(MIN, "          m[j] = m[j] + k4_score(x[j], y[j], "
                             "z[j], q);")],
    # registers up to 255 a thread (blocks of at most 256 threads)
    "launch bounds 256": [("#define K4_MAX_THREADS 512",
                           "#define K4_MAX_THREADS 256")],
    # lanes of 16 (two groups a warp), 13 points a thread: 130 blocks
    "ppt13": [("    case 8: launch<8>(a, blocks, threads, smem, st); break;",
               "    case 8: launch<8>(a, blocks, threads, smem, st); break;\n"
               "    case 13: launch<13>(a, blocks, threads, smem, st); "
               "break;")],
    "no scan": [NO_SCAN],
    "no scan, no staging": [NO_SCAN, (
        "for (int k0 = tid; k0 < n; k0 += 4 * T)",
        "for (int k0 = n; k0 < n; k0 += 4 * T)")],
}
# variants launched at a geometry k4_geometry does not offer
GEOMETRY = {"ppt13": dict(threads=256, splits=16, ppt=13, points=208,
                          blocks=130, chunk=1000,
                          smem=1000 * 16 + 16 * 208 * 8)}


def scan_loop_length(lib_path, ppt=7):
    """(instructions, LDS.128) of the scan loop of k_closest_surface<ppt>
    in the built library's SASS."""
    import re
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    fn = sass.split(f"k_closest_surfaceILi{ppt}E")[1].split("Function :")[0]
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    best = None
    for addr, op in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            lds = sum("LDS.128" in o for o in body)
            if lds >= 8 and (best is None or len(body) < best[0]):
                best = (len(body), lds)
    return best


def main(argv=None):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as C
    from isdf_tpu_torch.ops import cuda_bounds as CB
    from isdf_tpu_torch.utils import nvcc

    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    if not torch.cuda.is_available():
        sys.exit("k4_probe: no CUDA device")
    print(f"card: {C.card_line()}", flush=True)
    x = C.make_inputs(torch)
    pts, surf, sv = x["pts"], x["pc"][:, 0], x["ray_valid"]

    def dev_ms(fn, reps=50):
        d = [dur for _, dur, n in C.traced_kernels(torch, fn, reps)
             if "k_closest_surface" in n]
        return sum(d) / len(d) / 1e3

    g = torch.Generator(device="cuda").manual_seed(0)
    more = torch.randn(4000, 3, device="cuda", generator=g)
    more_v = torch.rand(4000, device="cuda", generator=g) > 0.1
    for R in (8, 64, 250, 500, 1000, 2000, 4000):
        s_, v_ = (surf[:R], sv[:R]) if R <= 1000 else (more[:R], more_v[:R])
        ms = dev_ms(lambda: CB.closest_surface_ix(pts, s_, v_))
        print(f"R {R}: {ms:.5f} ms", flush=True)

    stop = []

    def loop():
        while not stop:
            for _ in range(200):
                CB.closest_surface_ix(pts, surf, sv)
            torch.cuda.synchronize()

    t = threading.Thread(target=loop)
    t.start()
    time.sleep(1.0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "(SM clock, max, power under K4)")
    stop.append(1)
    t.join()

    n, lds = scan_loop_length(nvcc._target(nvcc.CSRC, "bounds_pc"))
    print(f"scan loop of k_closest_surface<7>: {n} instructions, {lds} "
          f"LDS.128 (a run of 8 rows x 7 points: {n / 56:.2f} a pair)",
          flush=True)

    base = os.path.join(nvcc.build_dir(), "k4_probe")
    dirs = {}
    for name in names:
        d = os.path.join(base, name.replace(" ", "_").replace(",", ""))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(nvcc.CSRC, d)
        path = os.path.join(d, "bounds_pc.cu")
        with open(path) as f:
            src = f.read()
        for a, b in VARIANTS[name]:
            assert a in src, f"{name}: text not found"
            src = src.replace(a, b)
        with open(path, "w") as f:
            f.write(src)
        dirs[name] = d
    nvcc.build([(d, "bounds_pc") for d in dirs.values()])
    want = CB.closest_surface_ix_plain(pts, surf, sv)
    for _ in range(2):
        for name in ["shipped"] + names:
            d = dirs.get(name, nvcc.CSRC)
            with nvcc.sources_from(d):
                geo = GEOMETRY.get(name)

                def fn():
                    return CB.closest_surface_ix_cuda(pts, surf, sv,
                                                      geometry=geo)

                print(f"{name}: {dev_ms(fn):.5f} ms, indices equal to the "
                      f"plain version's: {torch.equal(fn(), want)}",
                      flush=True)


if __name__ == "__main__":
    main()
