"""ReplicaCAD- and ScanNet-format benchmark fixtures (isdf_tpu/data/
fixtures.py).

Renders an analytic synthetic scene (data/synthetic.py) into the exact
on-disk layout the reference's real-data benchmark pipeline consumes, so
the load-bearing product path — ``train/train.py --config X.json`` →
``vox_res.json`` → figure scripts — can run end-to-end with zero mounted
data:

  * sequence dir: ``traj.txt`` (N×16 poses) + ``results/frame%06d.png``
    + ``results/[n]depth%06d.png`` uint16 depth PNGs
    (reference isdf/datasets/dataset.py:20-71 conventions);
  * GT SDF: ``gt_sdf_dir/1cm/{sdf.npy, transform.txt}`` + ``mesh.obj``
    (reference isdf/modules/trainer.py:207,446-453);
  * eval_pts mask tree: ``eval_pts/vox/<frac>/<seq>/eval_pts/<t>/*.npy``
    validity masks + ``eval_pts/full_vol/{replicaCAD.npy, gt_<seq>.npy}``
    pre-baked volume points (reference isdf/eval/eval_pts.py:96-299);
  * ``obj_bounds.txt`` per-object eval boxes (reference
    isdf/eval/metrics.py:116-130);
  * a reference-schema config JSON pointing at all of the above.

The masks are generated by READING BACK the written PNGs through the
same ``ReplicaDataset`` + ``SceneCache`` stack the trainer uses, so the
uint16 quantisation and the deterministic torch-RNG point stream match
what ``Trainer.eval_fixed`` will sample bit-for-bit. Images are written
by the port's own codec (utils/image_io.py, PNG and baseline JPEG);
``device`` is where the scene renders its depth.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from isdf_tpu_torch.ops import geometry as G
from isdf_tpu_torch.utils import image_io as IO

# frac_time_perception -> voxblox eval-dir name (reference trainer.py:273-283)
FRAC_DIRS = {1.0: "0.055", 0.75: "0.063", 0.5: "0.078", 0.25: "0.11"}


def _write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def _config_dict(seq_dir, gt_sdf_dir, eval_pts_root, cam, depth_scale, fps,
                 eval_samples, frac_time_perception, hidden_size,
                 n_embed_funcs, n_rays, steps,
                 bounds_method: str = "ray") -> dict:
    """Reference-schema config (isdf/train/configs/replicaCAD.json:1-84)
    pointed at the fixture paths."""
    return {
        "tpu": {"kf_buffer_size": 160, "mm_precision": "default",
                "compute_dtype": "float32", "data_parallel": 1,
                "grad_mode": "pallas"},
        "loss": {"bounds_method": bounds_method, "loss_type": "L1",
                 "trunc_weight": 5.3834402, "trunc_distance": 0.29365022,
                 "eik_weight": 0.268, "eik_apply_dist": 0.1,
                 "grad_weight": 0.018, "orien_loss": 0},
        "sample": {"n_rays": n_rays, "n_rays_is_kf": 2 * n_rays,
                   "n_strat_samples": 19, "n_surf_samples": 8,
                   "depth_range": [0.07, 12.0], "dist_behind_surf": 0.1},
        "model": {"do_active": 0,
                  "frac_time_perception": frac_time_perception,
                  "scale_output": 0.14, "noise_std": 0.25,
                  "noise_kf": 0.08, "noise_frame": 0.04, "window_size": 5,
                  "hidden_layers_block": 2,
                  "hidden_feature_size": hidden_size,
                  "iters_per_kf": 60, "iters_per_frame": 10,
                  "kf_dist_th": 0.1, "kf_pixel_ratio": 0.65,
                  "embedding": {"scale_input": 0.05937489,
                                "n_embed_funcs": n_embed_funcs,
                                "gauss_embed": 0, "gauss_embed_std": 11,
                                "optim_embedding": 0}},
        "optimiser": {"lr": 0.0013, "weight_decay": 0.012},
        "trainer": {"steps": steps},
        "eval": {"do_vox_comparison": 1, "do_eval": 1, "eval_freq_s": 1,
                 "sdf_eval": 1, "mesh_eval": 0,
                 "eval_samples": eval_samples,
                 "eval_pts_root": eval_pts_root},
        "save": {"save_period": 10, "save_checkpoints": 0,
                 "save_slices": 0, "save_meshes": 0},
        "dataset": {"format": "replicaCAD", "depth_scale": depth_scale,
                    "fps": fps, "camera": cam, "seq_dir": seq_dir,
                    "gt_sdf_dir": gt_sdf_dir, "noisy_depth": 1},
    }


def write_replicaCAD_fixture(
    root: str,
    preset: str = "room_a",
    seq_name: Optional[str] = None,
    n_frames: int = 90,
    H: int = 60,
    W: int = 80,
    hfov_deg: float = 70.0,
    fps: float = 30.0,
    depth_scale: float = 3276.75,
    grid_dim: int = 96,
    grid_pad: float = 0.3,
    mesh_dim: int = 64,
    eval_times: Sequence[float] = (1.0, 2.0),
    eval_samples: int = 200000,
    frac_time_perception: float = 1.0,
    vox_shrink: float = 0.85,
    depth_noise_std: float = 0.0,
    hidden_size: int = 256,
    n_embed_funcs: int = 5,
    n_rays: int = 200,
    steps: int = 20000,
    bounds_method: str = "ray",
    seed: int = 0,
    device="cpu",
) -> str:
    """Synthesize a full ReplicaCAD-format benchmark fixture under
    ``root``; returns the path of the written config JSON.

    vox_shrink: the simulated voxblox-coverage region is the scene box
    shrunk by this factor — so the vox masks select a real, non-trivial
    subset exactly like the reference's baseline-coverage masks.
    depth_noise_std: optional Gaussian depth noise in metres (the
    "ndepth" files; the reference's noisy renders use a kinect model)."""
    from isdf_tpu_torch.data.datasets import ReplicaDataset
    from isdf_tpu_torch.data.synthetic import SyntheticDataset, make_scene
    from isdf_tpu_torch.utils.config import load_config

    seq = seq_name or f"{preset}_nav"
    seq_dir = os.path.join(root, "seqs", seq)
    res_dir = os.path.join(seq_dir, "results")
    gt_dir = os.path.join(root, "gt_sdfs", preset)
    eval_root = os.path.join(root, "eval_pts")
    frac_dir = FRAC_DIRS[frac_time_perception]
    masks_root = os.path.join(eval_root, "vox", frac_dir, seq, "eval_pts")
    vol_dir = os.path.join(eval_root, "full_vol")
    for d in (res_dir, os.path.join(gt_dir, "1cm"), masks_root, vol_dir):
        os.makedirs(d, exist_ok=True)

    # ---- render + write the sequence --------------------------------
    scene = make_scene(preset)
    ds = SyntheticDataset(scene, n_frames=n_frames, H=H, W=W,
                          hfov_deg=hfov_deg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    Ts = []
    for i in range(n_frames):
        s = ds[i]
        depth = s["depth"].copy()
        if depth_noise_std > 0:
            noise = rng.normal(0.0, depth_noise_std, depth.shape)
            depth = np.where(depth > 0, depth + noise, 0.0)
        q = np.clip(np.round(depth * depth_scale), 0, 65535).astype(np.uint16)
        # both clean and "noisy" names so either noisy_depth setting reads
        IO.imwrite(os.path.join(res_dir, f"depth{i:06d}.png"), q)
        IO.imwrite(os.path.join(res_dir, f"ndepth{i:06d}.png"), q)
        IO.imwrite(os.path.join(res_dir, f"frame{i:06d}.png"),
                   s["image"][..., ::-1])  # reader flips BGR->RGB back
        Ts.append(s["T"].reshape(-1))
        ds._cache.clear()  # frames can be large; don't hold them all
    np.savetxt(os.path.join(seq_dir, "traj.txt"), np.stack(Ts))

    # ---- GT SDF grid + scene mesh ------------------------------------
    sdf_grid, transform = scene.gt_sdf_grid(dim=grid_dim, pad=grid_pad)
    np.save(os.path.join(gt_dir, "1cm", "sdf.npy"), sdf_grid)
    np.savetxt(os.path.join(gt_dir, "1cm", "transform.txt"), transform)
    verts, faces = ds.gt_mesh(dim=mesh_dim)
    _write_obj(os.path.join(gt_dir, "mesh.obj"), verts, faces)

    # ---- per-object eval boxes ---------------------------------------
    rows = []
    for c, r in scene.spheres:
        c = np.asarray(c, np.float32)
        rows += [c - r, c + r]
    for c, he in scene.boxes:
        c, he = np.asarray(c, np.float32), np.asarray(he, np.float32)
        rows += [c - he, c + he]
    np.savetxt(os.path.join(seq_dir, "obj_bounds.txt"), np.stack(rows))

    # ---- config ------------------------------------------------------
    cam = dict(w=W, h=H, fx=float(ds.fx), fy=float(ds.fy),
               cx=float(ds.cx), cy=float(ds.cy))
    cfg_dict = _config_dict(
        seq_dir + "/", gt_dir + "/", eval_root + "/", cam, depth_scale,
        fps, eval_samples, frac_time_perception, hidden_size,
        n_embed_funcs, n_rays, steps, bounds_method=bounds_method)
    cfg_path = os.path.join(root, f"{seq}_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_dict, f, indent=2)

    # ---- eval_pts masks + full-volume points --------------------------
    cfg = load_config(cfg_path)
    read_back = ReplicaDataset(seq_dir, cfg)
    gt_fn = _grid_fn(sdf_grid, transform)
    _write_eval_tree(
        masks_root, vol_dir, read_back, scene, gt_fn,
        dirs_C=G.ray_dirs_C(H, W, ds.fx, ds.fy, ds.cx, ds.cy).numpy(),
        fps=fps, n_frames=n_frames, eval_times=eval_times,
        eval_samples=eval_samples, vox_shrink=vox_shrink,
        dist_behind=0.1, vol_name="replicaCAD", seq=seq, rng=rng)

    return cfg_path


def _grid_fn(sdf_grid, transform, absolute: bool = False):
    from isdf_tpu_torch.data import sdf_util as SU
    grid = np.abs(sdf_grid) if absolute else sdf_grid
    interp = SU.sdf_interpolator(grid, transform)
    return lambda p: SU.eval_sdf_interp(interp, p, handle_oob="fill",
                                        oob_val=np.nan)


def _write_eval_tree(masks_root, vol_dir, dataset, scene, gt_fn, *,
                     dirs_C, fps, n_frames, eval_times, eval_samples,
                     vox_shrink, dist_behind, vol_name, seq, rng,
                     gt_vol_fn=None):
    """Replay the fixed protocol's exact deterministic sampling against
    the read-back dataset and bake the validity masks + full-volume
    points (reference eval_pts.py:96-299 layout). ``dist_behind`` is 0.0
    for ScanNet, 0.1 otherwise (fixed_pts_eval)."""
    from isdf_tpu_torch.data.datasets import SceneCache
    from isdf_tpu_torch.eval.eval_pts import _torch_sample_rays, eval_grad_fd

    cache = SceneCache(dataset, skip=5)
    half_vox = scene.extents / 2.0 * vox_shrink
    lo_vox = scene.center - half_vox
    hi_vox = scene.center + half_vox

    def in_vox(pts):
        return np.all((pts >= lo_vox) & (pts <= hi_vox), axis=-1)

    for t in eval_times:
        t_str = f"{float(t):.3f}"
        tdir = os.path.join(masks_root, t_str)
        os.makedirs(tdir, exist_ok=True)
        n_seen = min(max(int(t * fps), 1), n_frames)
        sample = cache[np.arange(n_seen)]
        depth_b, T_b = sample["depth"], sample["T"]

        # visible region
        pts = _torch_sample_rays(t_str, depth_b, T_b, dirs_C, dist_behind,
                                 surface=False, samples=eval_samples)
        gt = np.asarray(gt_fn(pts)).reshape(-1)
        vis_valid = np.isfinite(gt)
        np.save(os.path.join(tdir, "vis_valid_gt_sdf.npy"), vis_valid)
        np.save(os.path.join(tdir, "vis_valid_vox_sdf.npy"),
                in_vox(pts[vis_valid]))
        # grad validity over ALL sampled points (the protocol intersects
        # it with the finite-FD check at eval time)
        gt_grad = eval_grad_fd(gt_fn, pts, 0.01)
        np.save(os.path.join(tdir, "vis_valid_gt_grad.npy"),
                np.isfinite(gt_grad).all(-1) & vis_valid)
        # vox grad mask file exists in the reference tree; the protocol
        # derives the vox grad subset by chaining sdf masks, so this one
        # mirrors the vox sdf coverage at full point length
        np.save(os.path.join(tdir, "vis_valid_vox_grad.npy"),
                np.isfinite(gt_grad).all(-1) & vis_valid & in_vox(pts))

        # surface region
        pts_s = _torch_sample_rays(t_str, depth_b, T_b, dirs_C, 0.0,
                                   surface=True, samples=eval_samples)
        gt_s = np.asarray(gt_fn(pts_s)).reshape(-1)
        surf_valid = np.isfinite(gt_s)
        np.save(os.path.join(tdir, "surf_valid_gt_sdf.npy"), surf_valid)
        np.save(os.path.join(tdir, "surf_valid_vox_sdf.npy"),
                in_vox(pts_s[surf_valid]))

    # pre-baked full-volume points (reference eval_pts.py:260-297:
    # replicaCAD sequences share full_vol/replicaCAD.npy, ScanNet uses
    # full_vol/<seq>.npy; GT values in full_vol/gt_<seq>.npy)
    m = max(eval_samples // 10, 1000)
    half = scene.extents / 2.0 - 0.05
    vol_pts = rng.uniform(scene.center - half, scene.center + half,
                          size=(m, 3)).astype(np.float32)
    np.save(os.path.join(vol_dir, vol_name + ".npy"), vol_pts)
    vol_gt = ((gt_vol_fn or scene.sdf_np)(vol_pts))
    np.save(os.path.join(vol_dir, f"gt_{seq}.npy"),
            np.asarray(vol_gt, np.float32))


def _scannet_config_dict(seq_dir, scannet_dir, intrinsics_file,
                         gt_sdf_dir, eval_pts_root, depth_scale, fps,
                         eval_samples, frac_time_perception, hidden_size,
                         n_embed_funcs, n_rays, steps,
                         bounds_method) -> dict:
    """Reference-schema ScanNet config (isdf/train/configs/scannet.json)."""
    d = _config_dict(seq_dir, gt_sdf_dir, eval_pts_root, {}, depth_scale,
                     fps, eval_samples, frac_time_perception, hidden_size,
                     n_embed_funcs, n_rays, steps,
                     bounds_method=bounds_method)
    d["dataset"] = {"format": "ScanNet", "seq_dir": seq_dir,
                    "scannet_dir": scannet_dir,
                    "intrinsics_file": intrinsics_file,
                    "gt_sdf_dir": gt_sdf_dir,
                    "depth_scale": depth_scale, "fps": fps}
    # reference scannet.json uses a higher trunc weight
    d["loss"]["trunc_weight"] = 14.2
    return d


def write_scannet_fixture(
    root: str,
    preset: str = "room_c",
    seq_name: Optional[str] = None,
    n_frames: int = 45,
    H: int = 48,
    W: int = 64,
    hfov_deg: float = 70.0,
    fps: float = 30.0,
    depth_scale: float = 1000.0,
    grid_dim: int = 64,
    grid_pad: float = 0.3,
    mesh_dim: int = 48,
    eval_times: Sequence[float] = (0.5, 1.4),
    eval_samples: int = 20000,
    frac_time_perception: float = 1.0,
    vox_shrink: float = 0.85,
    depth_noise_std: float = 0.0,
    hidden_size: int = 256,
    n_embed_funcs: int = 5,
    n_rays: int = 200,
    steps: int = 20000,
    bounds_method: str = "ray",
    seed: int = 0,
    device="cpu",
) -> str:
    """Synthesize a ScanNet-export-format fixture under ``root``:
    ``frames/{color/%d.jpg, depth/%d.png, pose/%d.txt}`` + the scene
    info txt (reference isdf/datasets/dataset.py:74-121 +
    trainer.py:335-346 conventions), the gt_sdf/mesh/eval_pts layout,
    and a reference-schema ScanNet config. The protocol differences vs
    replicaCAD are baked in: the trainer takes |grid| as GT
    (trainer.py:448-449) and the fixed eval samples with
    dist_behind_surf = 0 (eval_pts.py fixed_pts_eval); the masks here
    replay exactly that."""
    from isdf_tpu_torch.data.datasets import ScanNetDataset
    from isdf_tpu_torch.data.synthetic import SyntheticDataset, make_scene
    from isdf_tpu_torch.utils.config import load_config

    seq = seq_name or f"scene_{preset}"
    seq_dir = os.path.join(root, "scannet", seq)
    frames = os.path.join(seq_dir, "frames")
    gt_dir = os.path.join(root, "gt_sdfs", seq)
    eval_root = os.path.join(root, "eval_pts")
    frac_dir = FRAC_DIRS[frac_time_perception]
    masks_root = os.path.join(eval_root, "vox", frac_dir, seq, "eval_pts")
    vol_dir = os.path.join(eval_root, "full_vol")
    for d in (os.path.join(frames, "color"), os.path.join(frames, "depth"),
              os.path.join(frames, "pose"), os.path.join(gt_dir, "1cm"),
              masks_root, vol_dir):
        os.makedirs(d, exist_ok=True)

    scene = make_scene(preset)
    ds = SyntheticDataset(scene, n_frames=n_frames, H=H, W=W,
                          hfov_deg=hfov_deg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        s = ds[i]
        depth = s["depth"].copy()
        if depth_noise_std > 0:
            depth = np.where(depth > 0,
                             depth + rng.normal(0, depth_noise_std,
                                                depth.shape), 0.0)
        q = np.clip(np.round(depth * depth_scale), 0, 65535).astype(
            np.uint16)
        IO.imwrite(os.path.join(frames, "depth", f"{i}.png"), q)
        IO.imwrite(os.path.join(frames, "color", f"{i}.jpg"),
                   s["image"][..., ::-1])
        np.savetxt(os.path.join(frames, "pose", f"{i}.txt"), s["T"])
        ds._cache.clear()

    # scene info txt (reference trainer.py:335-346 keys)
    info = os.path.join(seq_dir, seq + ".txt")
    with open(info, "w") as f:
        f.write(f"fx_depth = {ds.fx}\nfy_depth = {ds.fy}\n"
                f"mx_depth = {ds.cx}\nmy_depth = {ds.cy}\n"
                f"depthWidth = {W}\ndepthHeight = {H}\n")

    sdf_grid, transform = scene.gt_sdf_grid(dim=grid_dim, pad=grid_pad)
    np.save(os.path.join(gt_dir, "1cm", "sdf.npy"), sdf_grid)
    np.savetxt(os.path.join(gt_dir, "1cm", "transform.txt"), transform)
    verts, faces = ds.gt_mesh(dim=mesh_dim)
    _write_obj(os.path.join(gt_dir, "mesh.obj"), verts, faces)

    cfg_dict = _scannet_config_dict(
        seq_dir + "/", seq_dir + "/", info, gt_dir + "/", eval_root + "/",
        depth_scale, fps, eval_samples, frac_time_perception, hidden_size,
        n_embed_funcs, n_rays, steps, bounds_method)
    cfg_path = os.path.join(root, f"{seq}_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_dict, f, indent=2)

    cfg = load_config(cfg_path)
    read_back = ScanNetDataset(seq_dir, cfg)
    # the trainer evaluates against |grid| for ScanNet (TSDF-fusion GT
    # grids carry unreliable signs, trainer.py:448-449)
    gt_fn = _grid_fn(sdf_grid, transform, absolute=True)
    _write_eval_tree(
        masks_root, vol_dir, read_back, scene, gt_fn,
        dirs_C=G.ray_dirs_C(H, W, ds.fx, ds.fy, ds.cx, ds.cy).numpy(),
        fps=fps, n_frames=n_frames, eval_times=eval_times,
        eval_samples=eval_samples, vox_shrink=vox_shrink,
        dist_behind=0.0, vol_name=seq, seq=seq, rng=rng,
        gt_vol_fn=lambda p: np.abs(scene.sdf_np(p)))

    return cfg_path
