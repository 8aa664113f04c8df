"""Oracle debugging harness: bound targets against the true SDF along rays
(isdf_tpu/eval/debug.py).

The reference ships this only as the commented-out ``Trainer.check_gt_sdf``
(isdf/modules/trainer.py:870-949, call site commented at :859-861): a
panel plotting the three self-supervised bound targets against the GT SDF
along a few sampled rays, the visual argument behind the paper's bound
construction. Here it is a working utility that also overlays the
network's predicted SDF.

The sampling, the bounds (ops/bounds.py) and the ``sdf_fn`` query run on
the trainer's device, from a ``torch.Generator`` seeded on that device;
the GT oracle is the dataset's host function. Only the figures are drawn
on the host, by the port's plot kit (vis/plot.py).

Use it when supervision looks wrong: if the "Batch distance" curve hugs
the GT while "Ray" overshoots in free space, the bounds are healthy and
the problem is elsewhere; if pc diverges from GT near the surface, the
surface sample set is too sparse (tpu.pc_surf_budget).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from isdf_tpu_torch.ops import bounds as BD
from isdf_tpu_torch.ops import sampling as S
from isdf_tpu_torch.vis import plot as plt


def ray_oracle(trainer, slot: int = 0, n_rays: int = 3, seed: int = 0,
               draws=None) -> List[Dict[str, np.ndarray]]:
    """Sample ``n_rays`` valid rays from keyframe ``slot`` and return, per
    ray, the sample depths plus every supervision signal along them.

    Returns a list of dicts with keys ``z`` (euclidean distance along the
    ray, sorted ascending), ``ray`` / ``normal`` / ``pc`` (the three bound
    targets, reference loss.py:13-89), ``pred`` (network SDF) and ``gt``
    (true SDF; NaN-filled when the trainer has no GT oracle). ``draws``
    (tests): sample_rays_from_frames's draws for the 4 * n_rays (at least
    64) rays it oversamples.
    """
    buf = trainer.buffer
    count = int(buf.count)
    if count == 0:
        raise ValueError("empty keyframe buffer — ingest a frame first")
    slot = slot % count
    cfg = trainer.cfg
    dev = buf.depth.device

    depth = buf.depth[slot:slot + 1]
    T_WC = buf.T_WC[slot:slot + 1]
    normals = (buf.normals[slot:slot + 1]
               if buf.normals is not None else None)

    # oversample so n_rays valid (non-zero-depth) rays survive the mask
    draw = max(4 * n_rays, 64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rs = S.sample_rays_from_frames(
        gen, depth, T_WC, trainer.dirs_C, normals,
        torch.ones((1,), dtype=torch.bool, device=dev), draw,
        cfg.min_depth, cfg.dist_behind_surf, cfg.n_strat_samples,
        cfg.n_surf_samples, draws=draws)

    methods = {"ray": True, "normal": normals is not None, "pc": True}
    curves = {}
    for name, ok in methods.items():
        if ok:
            curves[name] = BD.compute_bounds(
                name, rs.dirs_C, rs.depth, rs.dirs_W, rs.z_vals, rs.pc,
                cfg.trunc_distance, rs.normals, rs.valid,
                do_grad=False).bounds.cpu().numpy()

    R, Ssz = rs.z_vals.shape
    pred = trainer.sdf_fn(rs.pc.reshape(-1, 3)).reshape(R, Ssz)
    pc_host = rs.pc.cpu().numpy()
    if getattr(trainer, "gt_sdf_fn", None) is not None:
        gt = np.asarray(trainer.gt_sdf_fn(
            pc_host.reshape(-1, 3))).reshape(R, Ssz)
    else:
        gt = np.full((R, Ssz), np.nan, np.float32)

    z_euc = (rs.z_vals * rs.dirs_C.norm(dim=-1)[:, None]).cpu().numpy()
    valid = rs.valid.cpu().numpy()

    out = []
    for i in np.flatnonzero(valid)[:n_rays]:
        order = np.argsort(z_euc[i])
        ray = {"z": z_euc[i][order], "pred": pred[i][order],
               "gt": gt[i][order]}
        for name, c in curves.items():
            ray[name] = c[i][order]
        out.append(ray)
    return out


def vis_embedding(out_file: str, scale: float = 1.0,
                  min_deg: int = 0, max_deg: int = 5,
                  B: Optional[np.ndarray] = None,
                  x_max: float = 5.0, n: int = 640) -> str:
    """Frequency-band heatmap of the positional encoding along a 1-D
    sweep — the WORKING version of the reference's ``vis_embedding``
    (embedding.py:74-93, broken as shipped: its gauss branch reads a
    ``gauss_embed`` attribute that is never created).

    Plots sin(x * scale * 2^k) per band over x in [0, x_max]; when a
    random-Fourier matrix ``B`` is given ([3, F], ops/embedding.py), its
    sorted per-feature norms are used as the frequency bands instead,
    matching the reference's intent."""
    if B is not None:
        if isinstance(B, torch.Tensor):
            B = B.detach().cpu().numpy()
        bands = np.sort(np.linalg.norm(np.asarray(B), axis=0))
    else:
        nf = max_deg - min_deg + 1
        bands = 2.0 ** np.linspace(min_deg, max_deg, nf)
    x = np.linspace(0.0, x_max, n)
    emb = np.sin(x[:, None] * scale * bands[None, :])

    fig, ax = plt.subplots(figsize=(8, 3.2))
    im = ax.imshow(emb.T, cmap="hot", interpolation="nearest",
                   aspect="auto", origin="lower",
                   extent=[0, x_max, 0, emb.shape[1]])
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("x values")
    ax.set_ylabel("embeddings")
    fig.tight_layout()
    fig.savefig(out_file, dpi=110)
    plt.close(fig)
    return out_file


def ray_oracle_figure(trainer, out_file: str, slot: int = 0,
                      n_rays: int = 3, seed: int = 0,
                      rays: Optional[List[Dict[str, np.ndarray]]] = None):
    """Write the check_gt_sdf-style panel figure (one row per ray):
    GT SDF vs the ray / normal / batch-distance bounds and the predicted
    SDF along each sampled ray (reference trainer.py:890-935 layout)."""
    if rays is None:
        rays = ray_oracle(trainer, slot=slot, n_rays=n_rays, seed=seed)
    fig, axes = plt.subplots(len(rays), 1,
                             figsize=(11, 3.3 * len(rays)), squeeze=False)
    series = [("gt", "True signed distance", "C1"),
              ("ray", "Ray", "C3"),
              ("normal", "Normal", "C2"),
              ("pc", "Batch distance", "C0")]
    for j, ray in enumerate(rays):
        ax = axes[j, 0]
        x = ray["z"]
        ax.hlines(0, x[0], x[-1], color="gray", linestyle="--", lw=1)
        for key, label, color in series:
            if key in ray and np.isfinite(ray[key]).any():
                ax.plot(x, ray[key], label=label, color=color, lw=2.5)
        ax.plot(x, ray["pred"], label="Predicted", color="k",
                linestyle=":", lw=2)
        if j == 0:
            ax.legend(fontsize=9, ncol=2)
        if j == len(rays) - 1:
            ax.set_xlabel("Distance along ray, d [m]")
    fig.text(0.04, 0.5, "Signed distance [m]", va="center",
             rotation="vertical")
    fig.savefig(out_file, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_file
