#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (isdf_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --kernels-only

Phases (any failure is an uncaught exception and a non-zero exit):
  1. build the kernel library from isdf_tpu_torch/csrc with nvcc;
  2. hold each train-op kernel (K1-pc, K1-ray) against its plain PyTorch
     version at the trainer's shapes (N = 27,000 points, R = 1,000 surface
     points, full-width random weights from a seed) and time both;
  3. drive the online trainer through its entry points (Trainer +
     train_loop) on isdf_tpu_torch/train/configs/synthetic.json with the
     simulated clock pinned, once as shipped (pc bounds -> K1-pc) and once
     with loss.bounds_method=ray (-> K1-ray); each run starts with the
     launch counts at 0 and must launch its kernel once per step, lower its
     loss, promote keyframes and lower the SDF error against the scene's
     analytic SDF;
  4. print the card, the kernels' JSON line, and the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances of kernel vs plain version, both with bf16 hidden products on
# the same bf16 operands: about 10x the largest gap read on the card
# (PERF.md, Findings PR 1: sums 2.6e-6, per-point loss 7.1e-4, gradient
# blocks 5.5e-5); a copy with one block zeroed fails at 1.0.
TOL_SUMS_REL = 3e-5     # |k - p| / |p| per loss sum; the count is exact
TOL_PLOSS = 5e-3        # max |k - p| / max |p| of the per-point loss
TOL_GRAD = 5e-4         # the same per gradient block (grad_blocks)

PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s

CONFIG = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                      "synthetic.json")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_inputs(torch, N_rays=1000, S=27, R=1000, seed=0):
    """A ray batch shaped like the trainer's: rays from points near the
    room centre, surface sample first, 90% valid rays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (N_rays, 3)).astype(np.float32)
    d = rng.normal(size=(N_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = rng.uniform(0.8, 3.0, N_rays).astype(np.float32)
    z = np.sort(rng.uniform(0.07, 1.0, (N_rays, S)).astype(np.float32)
                * (depth[:, None] + 0.1), axis=1)
    z[:, 0] = depth
    pc = o[:, None] + d[:, None] * z[..., None]
    valid = rng.random(N_rays) > 0.1
    normals = rng.normal(size=(N_rays, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    N = N_rays * S
    f = dict(
        pts=pc.reshape(N, 3),
        surf=pc[:R, 0].copy(),
        surf_valid=valid[:R].astype(np.float32),
        zd=(z - depth[:, None]).reshape(N),
        normals_pt=np.repeat(normals, S, axis=0),
        is_surf=np.tile(np.eye(1, S, dtype=np.float32)[0], N_rays),
        valid=np.repeat(valid, S).astype(np.float32),
        noise=(rng.normal(size=N) * 0.04).astype(np.float32),
        bounds=(depth[:, None] - z).reshape(N),
        gt=np.repeat(-d, S, axis=0),
    )
    out = {k: torch.as_tensor(v).cuda().contiguous() for k, v in f.items()}
    out["inv_count"] = torch.tensor(1.0 / max(float(f["valid"].sum()), 1.0),
                                    device="cuda")
    return out


def grad_blocks(model, dW, db):
    """The gradient by block: each layer's weight rows (the skip layer's
    main rows and pe rows apart) and each layer's bias, so a wrong block
    with small gradients is not hidden by the largest one."""
    from isdf_tpu_torch.models.sdf_mlp import unpack
    H = model.hidden_size
    out = {}
    for l, (w, b) in enumerate(unpack({"Wp": dW, "bp": db}, model)):
        if l == model.cat_idx:
            out[f"dW{l}"], out[f"dW{l}.pe"] = w[:H], w[H:]
        else:
            out[f"dW{l}"] = w
        out[f"db{l}"] = b
    return out


def flop_count(model, N, R, pc):
    """Operations of one train-op call, recounted from its code: per point
    3(nh+1) products with a 256x256 matrix (forward, v-chain, tangent
    chain, the skip layer twice), 2(nh-1) in the backward chain and
    2(nh+1) in dW, all bf16; in f32 the PE (7 per lane), the scores
    (7 per surface point) and the tangent contractions."""
    nh = model.n_layers - 1
    H = model.hidden_size
    n_mm = 3 * (nh + 1) + 2 * (nh - 1) + 2 * (nh + 1)
    bf16 = N * n_mm * 2 * H * H
    f32 = N * (7 * 256 + 2 * 3 * 256 + (7 * R if pc else 0))
    return bf16, f32


def byte_count(model, N, R, pc):
    """Each input read once, each output written once."""
    L = model.n_layers
    w = L * 512 * 256 * 4 + L * 256 * 4
    ins = N * 4 * (3 + 1 + 1 + (1 + 3 + 1 if pc else 1 + 3)) + w
    if pc:
        ins += R * 4 * 4
    outs = N * 4 + 5 * 4 + w
    return ins + outs


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_kernels(torch):
    from isdf_tpu_torch.models import cuda_mlp as K
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    model = M.SDFModel(mm_precision=cfg.mm_precision)
    params = {k: v.cuda() for k, v in M.init_params(
        torch.Generator().manual_seed(0), model).items()}
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.1, -0.2, 0.3])
    T = T.cuda()
    x = make_inputs(torch)
    N, R = x["pts"].shape[0], x["surf"].shape[0]
    rows = []
    for pc in (True, False):
        name = "K1-pc" if pc else "K1-ray"
        op = K.make_train_op(
            model, loss_type=cfg.loss_type,
            trunc_distance=cfg.trunc_distance, trunc_weight=cfg.trunc_weight,
            eik_apply_dist=cfg.eik_apply_dist, eik_weight=cfg.eik_weight,
            grad_weight=cfg.grad_weight, orien_loss=cfg.orien_loss,
            pc_bounds=pc)
        if pc:
            args = (params, T, x["pts"], x["surf"], x["surf_valid"], x["zd"],
                    x["normals_pt"], x["is_surf"], x["valid"], x["noise"],
                    x["inv_count"])
        else:
            args = (params, T, x["pts"], x["bounds"], x["valid"], x["noise"],
                    x["gt"], x["inv_count"])
        k_out = op(*args)
        k_again = op(*args)
        torch.cuda.synchronize()
        M_, dxs, dproj2 = M._pe_consts(model, T, device="cuda")
        Tc = K.tangent_rows(model, dxs, dproj2)
        lk = K._loss_knobs(model, cfg.loss_type, cfg.trunc_distance,
                           cfg.trunc_weight, cfg.eik_apply_dist,
                           cfg.eik_weight, cfg.grad_weight, cfg.orien_loss,
                           5.0)
        kw = (dict(surf=x["surf"], surf_valid=x["surf_valid"], zd=x["zd"],
                   normals_pt=x["normals_pt"], is_surf=x["is_surf"])
              if pc else dict(bounds=x["bounds"], gt=x["gt"]))

        def plain():
            return K.train_op_plain(params, model, lk, M_, Tc, x["pts"],
                                    x["valid"], x["noise"], x["inv_count"],
                                    mm_dtype=torch.bfloat16, **kw)

        p_out = plain()
        torch.cuda.synchronize()
        ks, kp, (kdw, kdb) = k_out
        ps, pp, (pdw, pdb) = p_out
        for t in (ks, kp, kdw, kdb):
            assert torch.isfinite(t).all(), f"{name}: non-finite output"
        deterministic = all(torch.equal(a, b) for a, b in zip(
            (ks, kp, kdw, kdb), (k_again[0], k_again[1], *k_again[2])))
        sums_rel = ((ks - ps).abs() / ps.abs().clamp(min=1e-12)).tolist()
        errs = {"ploss": (kp, pp)}
        kb, pb = grad_blocks(model, kdw, kdb), grad_blocks(model, pdw, pdb)
        errs.update((k, (kb[k], pb[k])) for k in kb)
        norm = {}
        for key, (a, b) in errs.items():
            d = (a - b).abs().max().item()
            norm[key] = (d, d / max(b.abs().max().item(), 1e-30))
        max_abs = max(v[0] for v in norm.values())
        print(f"{name}: sums kernel {ks.tolist()} plain {ps.tolist()}")
        print(f"{name}: sums rel err {sums_rel} (tol {TOL_SUMS_REL})")
        print(f"{name}: max abs err / max abs of the block (tol ploss "
              f"{TOL_PLOSS}, others {TOL_GRAD}): " + ", ".join(
                  f"{k} {v[1]:.3e}" for k, v in norm.items()))
        print(f"{name}: run-to-run identical: {deterministic}")
        assert max(sums_rel[:4]) <= TOL_SUMS_REL and sums_rel[4] == 0.0, \
            f"{name}: loss sums disagree with the plain version"
        for key, (d, rel) in norm.items():
            tol = TOL_PLOSS if key == "ploss" else TOL_GRAD
            assert rel <= tol, f"{name}: {key} disagrees ({rel:.3e} > {tol})"
        assert deterministic, f"{name}: two calls gave different bits"

        ms = time_ms(torch, lambda: op(*args), 20)
        plain_ms = time_ms(torch, plain, 3)
        fb, ff = flop_count(model, N, R, pc)
        nbytes = byte_count(model, N, R, pc)
        t_ops = fb / PEAK_BF16 + ff / PEAK_F32
        t_bytes = nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({(fb + ff) / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)")
        rows.append(dict(
            name=name, route="cuda",
            source="isdf_tpu_torch/csrc/train_mlp.cu",
            replaces=("isdf_tpu/models/pallas_mlp.py:726" if pc
                      else "isdf_tpu/models/pallas_mlp.py:685"),
            launches=0, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None))
    return rows


def run_trainer(torch, overrides, max_steps, sim_dt):
    """One run of the online trainer through its entry points. Returns
    (summary dict, launch counts of this run)."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import cuda_mlp as K
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, overrides=overrides)
    trainer = Trainer(cfg, seed=1)
    assert trainer.device.type == "cuda" and trainer.fns.uses_kernel
    trainer._per_step_device_s = sim_dt
    trainer._bill_exact = True
    trainer.dataset[0]
    mae0 = trainer.dataset.sdf_mae(trainer.sdf_fn)
    losses = []
    run_steps = trainer.run_steps

    def recording_run_steps(n):
        out = run_steps(n)
        losses.extend(out["total_loss"].tolist())
        return out

    trainer.run_steps = recording_run_steps
    maes, eval_s = [], [0.0]

    def hook(tr):
        t = time.perf_counter()
        maes.append(tr.dataset.sdf_mae(tr.sdf_fn))
        eval_s[0] += time.perf_counter() - t
        return {"sdf_mae": maes[-1]}

    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_loop(trainer, max_steps=max_steps, eval_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    n = max(len(losses) // 10, 1)
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    summary = dict(steps=res.steps, keyframes=len(res.kf_indices) + 1,
                   frames_seen=int(trainer.frames[-1].frame_id) + 1,
                   loss_first=first, loss_last=last, sdf_mae_before=mae0,
                   sdf_mae_after=maes[-1], wall_s=wall,
                   eval_s=eval_s[0], steps_per_s_wall=res.steps / wall,
                   steps_per_s_wall_no_eval=res.steps / (wall - eval_s[0]),
                   device_ms_per_step=1e3 * trainer.measured_s
                   / max(res.steps, 1))
    return summary, launches


def main():
    kernels_only = "--kernels-only" in sys.argv[1:]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from isdf_tpu_torch.models import cuda_mlp as K

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    K.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in K.BUILD_INFO.get("nvcc_log", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("ptxas:", line.strip())

    # ---- phase 2: kernels vs plain versions ----
    rows = check_kernels(torch)
    if kernels_only:
        print(json.dumps({"kernels": rows}))
        return

    # ---- phase 3: the trainer, once per path ----
    by_name = {r["name"]: r for r in rows}
    for name, overrides in (("K1-pc", None),
                            ("K1-ray", ["loss.bounds_method=ray"])):
        summary, launches = run_trainer(torch, overrides, max_steps=600,
                                        sim_dt=1.0 / 300)
        print(f"trainer[{name}]: {json.dumps(summary)}", flush=True)
        print(f"trainer[{name}]: launches {launches}", flush=True)
        assert launches[name] == summary["steps"], \
            f"{name}: {launches[name]} launches in {summary['steps']} steps"
        assert all(v == 0 for k, v in launches.items() if k != name)
        assert summary["loss_last"] < summary["loss_first"], \
            "loss did not fall"
        assert summary["keyframes"] >= 3, "too few keyframes promoted"
        assert summary["sdf_mae_after"] < summary["sdf_mae_before"], \
            "the SDF error did not fall"
        by_name[name]["launches"] = launches[name]

    # ---- phase 4: report ----
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
