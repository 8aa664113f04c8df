"""Debug oracles — the reference's commented-out checking harnesses made
to work (isdf_tpu/vis/debug.py).

check_gt_sdf: per-ray profiles of the bound TARGETS (ray / normal /
batch-distance) against the true signed distance along sampled rays
(reference Trainer.check_gt_sdf, isdf/modules/trainer.py:870-949 —
shipped commented out at its call site trainer.py:859-861). The plot is
the fastest way to see which supervision method is lying where: the ray
bound over-estimates in free space at grazing angles, the batch
distance hugs the true SDF, the normal bound is only valid near the
surface. The sampling and the bounds run on the trainer's device; the
figure is drawn on the host by vis/plot.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def check_gt_sdf(trainer, frame_ix: int = 0,
                 ray_ixs: Sequence[int] = (9, 19, 23),
                 n_rays: int = 100, seed: int = 0,
                 out_file: Optional[str] = None, draws=None):
    """Render the bound-target vs true-SDF profiles for a few rays of
    one buffered keyframe. Requires trainer.gt_sdf_fn (synthetic scenes
    and gt_sdf_dir runs have it). Returns the figure path (out_file) or
    the per-ray dict when out_file is None. ``draws`` (tests): (ih, iw, u,
    normal) for the pixel draw and sample_along_rays."""
    from isdf_tpu_torch.ops import bounds as B
    from isdf_tpu_torch.ops import sampling as S

    if trainer.gt_sdf_fn is None:
        raise ValueError("check_gt_sdf needs a GT SDF "
                         "(synthetic scene or gt_sdf_dir)")
    cfg = trainer.cfg
    depth_img = trainer.buffer.depth[frame_ix]
    T_WC = trainer.buffer.T_WC[frame_ix]
    dev = depth_img.device

    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        _, ih, iw = S.sample_pixels(gen, n_rays, 1, trainer.H, trainer.W,
                                    device=dev)
        ray_draws = None
    else:
        gen = None
        ih, iw = draws[0].to(dev), draws[1].to(dev)
        ray_draws = (draws[2].to(dev), draws[3].to(dev))
    depth = depth_img[ih, iw]
    dirs_C = trainer.dirs_C[ih, iw]
    pc, z_vals, origins, dirs_W = S.sample_along_rays(
        gen, T_WC.expand(n_rays, 4, 4), dirs_C, depth,
        cfg.min_depth, cfg.dist_behind_surf, cfg.n_strat_samples,
        cfg.n_surf_samples, draws=ray_draws)

    # sort by z like the reference (trainer.py:873-881)
    order = torch.argsort(z_vals, dim=1, stable=True)
    z_sorted = torch.take_along_dim(z_vals, order, dim=1)
    pc_sorted = torch.take_along_dim(pc, order[..., None], dim=1)

    valid = depth > 0
    t_ray = B.bounds_ray(depth, z_sorted, dirs_C, dirs_W).bounds
    t_pc = B.bounds_pc(pc_sorted, z_sorted, depth, valid).bounds
    t_normal = None
    if trainer.buffer.normals is not None and cfg.do_normal:
        normals = trainer.buffer.normals[frame_ix][ih, iw]
        t_normal = B.bounds_normal(
            depth, z_sorted, dirs_C, normals, cfg.trunc_distance,
            dirs_W).bounds.cpu().numpy()

    # euclidean distance along the ray (z * |dir|), reference :883-884
    z_euc = (z_sorted * dirs_C.norm(dim=-1, keepdim=True)).cpu().numpy()
    gt = np.asarray(trainer.gt_sdf_fn(
        pc_sorted.cpu().numpy().reshape(-1, 3))).reshape(z_euc.shape)
    t_ray, t_pc = t_ray.cpu().numpy(), t_pc.cpu().numpy()

    rows = {}
    for i in ray_ixs:
        rows[int(i)] = {
            "z": z_euc[i], "gt_sdf": gt[i],
            "ray": t_ray[i], "pc": t_pc[i],
            "normal": t_normal[i] if t_normal is not None else None,
        }
    if out_file is None:
        return rows

    from isdf_tpu_torch.vis import plot as plt

    fig, axes = plt.subplots(len(rows), 1,
                             figsize=(11, 3.3 * len(rows)),
                             squeeze=False)
    for j, (i, r) in enumerate(rows.items()):
        ax = axes[j][0]
        ax.hlines(0, r["z"][0], r["z"][-1], color="gray", linestyle="--")
        ax.plot(r["z"], r["gt_sdf"], label="True signed distance",
                color="C1", lw=2.5)
        ax.plot(r["z"], r["ray"], label="Ray", color="C3", lw=2.5)
        if r["normal"] is not None:
            ax.plot(r["z"], r["normal"], label="Normal", color="C2",
                    lw=2.5)
        ax.plot(r["z"], r["pc"], label="Batch distance", color="C0",
                lw=2.5)
        ax.set_ylabel("signed distance [m]")
        if j == 0:
            ax.legend(fontsize=9)
    axes[-1][0].set_xlabel("distance along ray, d [m]")
    fig.tight_layout()
    fig.savefig(out_file, dpi=120)
    plt.close(fig)
    return out_file
