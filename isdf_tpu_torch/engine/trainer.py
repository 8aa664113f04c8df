"""Trainer — the public orchestrator (isdf_tpu/engine/trainer.py; reference
isdf/modules/trainer.py).

Host responsibilities only: frame ingestion, the keyframe state machine,
the simulated clock, the scene frame and the eval queries. All per-step
compute runs in engine/step.py on the trainer's device.

Simulated-clock contract (reference trainer.py:100-101, 1011-1013): time
spent optimising, scaled by 1/frac_time_perception, advances
``tot_step_time``; the current camera frame is int(tot_step_time * fps).
On the card a bundle is billed its device time, read from CUDA events
recorded around it on the stream (the reference's own timing,
isdf/eval/metrics.py:13-38); on the CPU its wall time. Setting
``_per_step_device_s`` bills a fixed time per step instead, capped at the
measured time unless ``_bill_exact`` pins the clock exactly (replays).

``incremental=False`` is the batch mode: the chosen views are loaded as
keyframes at start and nothing is ingested later (reference
trainer.py:514-528).

Meshing (``get_sdf_grid_sparse``, ``mesh_rec``, ``write_mesh``), the mesh,
fixed-point (voxblox-comparable), object and trajectory evals, checkpoints
(utils/checkpoint.py, isdf_tpu's .npz format) and pose refinement
(engine/pose.py, ``model.refine_poses``) run as in isdf_tpu, and so do the
scene frame from ``gt_sdf_dir/mesh.obj``, the GT SDF grid from
``gt_sdf_dir/1cm`` and the SDF slices (vis/slices.py). Not ported yet: the
viewer and data parallelism; a config that asks for data parallelism
raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

from isdf_tpu_torch.data.frame_store import FrameData, FrameStore
from isdf_tpu_torch.engine import buffer as BUF
from isdf_tpu_torch.engine import pose as P
from isdf_tpu_torch.engine.step import StepFunctions, step_seed
from isdf_tpu_torch.models import fused_adamw
from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.ops import geometry as G
from isdf_tpu_torch.utils import nvcc
from isdf_tpu_torch.utils.config import Config, load_config
from isdf_tpu_torch.utils.device import resolve_device
from isdf_tpu_torch.utils.profiling import BundleClock, StepTimer


def pinned_dt(n_steps: int, measured: float, per_step_s: float,
              exact: bool) -> float:
    """The seconds a bundle of ``n_steps`` bills: its ``measured`` time,
    or ``per_step_s`` a step where that is set (capped at the measured
    time unless ``exact``); never below 10 us."""
    if per_step_s:
        dt = n_steps * per_step_s
        if not exact:
            dt = min(dt, measured)
    else:
        dt = measured
    return max(dt, 1e-5)


def check_supported(cfg: Config):
    """Raise on the parts of a config this port does not run yet."""
    if cfg.data_parallel > 1:
        raise NotImplementedError(
            "not ported to isdf_tpu_torch yet: tpu.data_parallel > 1")


class Trainer:
    def __init__(self, config, dataset=None, incremental: bool = True,
                 grid_dim: int = 200, seed: int = 1, device=None):
        self.device = resolve_device(device)
        self.cfg: Config = (load_config(config) if isinstance(config, str)
                            else config)
        cfg = self.cfg
        check_supported(cfg)
        self.incremental = incremental
        self.grid_dim = grid_dim
        self.chunk_size = 262144

        # ---- dataset & camera ----
        if dataset is None:
            from isdf_tpu_torch.data.datasets import make_dataset
            dataset = make_dataset(cfg, device=self.device)
        self.dataset = dataset
        cam_cfg = cfg.camera
        if cfg.dataset_format == "ScanNet" and cfg.intrinsics_file:
            # the camera of a ScanNet export is its scene info txt's
            # (isdf_tpu trainer.py:62-64)
            from isdf_tpu_torch.utils.config import scannet_cam_params
            cam_cfg = scannet_cam_params(cfg.intrinsics_file)
        cam = (dataset.camera() if hasattr(dataset, "camera") else dict(
            H=cam_cfg.h, W=cam_cfg.w, fx=cam_cfg.fx, fy=cam_cfg.fy,
            cx=cam_cfg.cx, cy=cam_cfg.cy))
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.dirs_C = G.ray_dirs_C(self.H, self.W, self.fx, self.fy,
                                   self.cx, self.cy, device=self.device)

        # ---- scene frame: the PE sees points in the unit-box frame
        # (reference trainer.py:103-155) ----
        self.gt_scene = hasattr(dataset, "scene_bounds")
        if self.gt_scene:
            T, extents = dataset.scene_bounds()
            self.set_scene_properties(np.asarray(T), np.asarray(extents))
        elif cfg.workspace_extents is not None:
            # user-defined workspace (reference trainer.py:114-119): the
            # bounds transform is Rz(rotate_z degrees) with the workspace
            # offset as translation; the centre is kept for visualisation
            a = np.deg2rad(cfg.workspace_rotate_z)
            c, s = np.cos(a), np.sin(a)
            T = np.array([[c, -s, 0, 0], [s, c, 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
            T[:3, 3] = np.asarray(cfg.workspace_offset, np.float32)
            self.scene_center = np.asarray(cfg.workspace_center, np.float32)
            self.set_scene_properties(T, np.asarray(cfg.workspace_extents))
        elif cfg.gt_sdf_dir and os.path.exists(
                os.path.join(cfg.gt_sdf_dir, "mesh.obj")):
            # the scene mesh beside the GT SDF gives the training domain,
            # its oriented bounds (reference trainer.py:207, 80-86, 121-123)
            from isdf_tpu_torch.utils.mesh3d import load_mesh
            verts, _ = load_mesh(os.path.join(cfg.gt_sdf_dir, "mesh.obj"))
            T_scene_to_box, extents = G.oriented_bounds(verts)
            self.set_scene_properties(
                np.linalg.inv(T_scene_to_box).astype(np.float32),
                np.asarray(extents, np.float32))
            self.scene_center = 0.5 * (verts.min(0) + verts.max(0))
            self.gt_scene = True
        else:
            # bootstrap domain, until the pointcloud refines it
            self.set_scene_properties(np.eye(4, dtype=np.float32),
                                      np.array([6.0, 6.0, 6.0], np.float32))

        # ---- model / optimiser / arena ----
        self.model = M.SDFModel(
            embedding_size=cfg.embedding_size,
            hidden_size=cfg.hidden_feature_size,
            hidden_layers_block=cfg.hidden_layers_block,
            scale_output=cfg.scale_output, scale_input=cfg.scale_input,
            min_deg=0, max_deg=cfg.n_embed_funcs,
            gauss_embed=cfg.gauss_embed,
            gauss_embed_std=cfg.gauss_embed_std,
            mm_precision=cfg.mm_precision)
        self.params = M.init_params(torch.Generator().manual_seed(seed),
                                    self.model, device=self.device)
        self.frozen_params = M.copy_params(self.params)
        self.fns = StepFunctions(cfg, self.model, self.H, self.W,
                                 self.dirs_C, self.device)
        # build the step's kernel libraries now, outside the simulated clock
        nvcc.load_all(self.fns.kernel_sources)
        self.opt_state = fused_adamw.init_state(self.params)
        self.buffer = BUF.make_buffer(cfg.kf_buffer_size, self.H, self.W,
                                      with_normals=cfg.do_normal,
                                      device=self.device)
        self.frames = FrameStore()

        # ---- keyframe / clock state (reference trainer.py:46-50) ----
        self.step_timer = StepTimer()
        self.tot_step_time = 0.0
        self.last_is_keyframe = False
        self.steps_since_frame = 0
        self.optim_frames = 0
        self.noise_std = cfg.noise_std
        self.lr_scale = 1.0
        self.tail_mode = False
        self.steps_taken = 0
        # step t of the run draws from step_seed(_bundle_seed, t); keyframe
        # checks draw from their own stream
        self._bundle_seed = step_seed(seed, 0x5DF)
        self._kf_gen = torch.Generator(device=self.device)
        self._kf_gen.manual_seed(step_seed(seed, 0x4B46))
        self._per_step_device_s = 0.0   # > 0: bill this per step
        self._bill_exact = False
        self.measured_s = 0.0   # summed measured bundle time (device on
        #                         the card), whatever the clock billed

        # optional pose refinement (isdf_tpu trainer.py:218-263): the loop
        # runs a burst on each ingested frame (engine/loop.py)
        self._last_kf_prop = 0.0   # no render evidence yet: refine
        self._last_burst_s = 0.0   # the last burst's measured time
        # seconds billed per burst in runs with a pinned clock; None bills
        # the measured time (isdf_tpu's _pose_burst_device_s)
        self._pose_burst_device_s = None
        self.pose_state = None
        if cfg.refine_poses:
            self.pose_state, _ = P.init_pose_state(cfg.kf_buffer_size,
                                                   device=self.device)
            self._pose_step = P.PoseRefiner(
                self.model, n_rays=cfg.n_rays,
                n_surf_samples=cfg.n_surf_samples, min_depth=cfg.min_depth)
            self._pose_gen = torch.Generator(device=self.device)
            self._pose_gen.manual_seed(step_seed(seed, 0x505E))
            # one burst at set-up: its first eigh initialises cuSOLVER,
            # which the sim clock must not bill
            warm, _ = P.init_pose_state(cfg.kf_buffer_size,
                                        device=self.device)
            self._pose_step(
                self.params, warm,
                torch.zeros((1, self.H, self.W), device=self.device),
                torch.eye(4, device=self.device)[None],
                torch.zeros((1,), dtype=torch.long, device=self.device),
                self.fns.dirs, self.transform_dev,
                torch.Generator(device=self.device).manual_seed(0),
                n_steps=cfg.pose_iters)[1].cpu()

        # GT SDF for eval (numpy [N, 3] -> [N]): the dataset's, the
        # analytic scene's, or the grid in gt_sdf_dir
        self.gt_sdf_fn = getattr(dataset, "gt_sdf_fn", None)
        if self.gt_sdf_fn is None and hasattr(dataset, "scene"):
            self.gt_sdf_fn = dataset.scene.sdf_np
        if self.gt_sdf_fn is None and cfg.gt_sdf_dir:
            self._load_gt_sdf_grid()

        # batch (non-incremental) mode: the chosen views become keyframes
        # now (reference trainer.py:514-528)
        if not incremental:
            idxs = list(cfg.im_indices)
            if not idxs and cfg.n_views > 0:
                n = len(self.dataset)
                if cfg.random_views:
                    idxs = list(np.random.default_rng(seed).choice(
                        np.arange(n), size=cfg.n_views, replace=False))
                else:
                    idxs = list(np.linspace(0, n, cfg.n_views, dtype=int,
                                            endpoint=False))
            for i in idxs:
                self.last_is_keyframe = True
                self.add_frame(self.get_data([int(i)])[0])
            self.last_is_keyframe = True

        # fixed (voxblox-comparable) eval timestamps, read from the
        # eval_pts data directory (reference trainer.py:268-292)
        self.eval_pts_dir = None
        self.eval_times: List[float] = []
        if cfg.do_vox_comparison and cfg.eval_pts_root and cfg.seq_dir:
            frac_dir = {1.0: "0.055", 0.75: "0.063", 0.5: "0.078",
                        0.25: "0.11"}[cfg.frac_time_perception]
            seq = [x for x in cfg.seq_dir.split("/") if x][-1]
            d = os.path.join(cfg.eval_pts_root, "vox", frac_dir, seq,
                             "eval_pts")
            if os.path.isdir(d):
                self.eval_pts_dir = d
                self.eval_times = sorted(float(x) for x in os.listdir(d))

    def _load_gt_sdf_grid(self):
        """gt_sdf_dir/1cm/{sdf.npy, transform.txt} -> a world-frame
        interpolator, NaN outside the grid; ScanNet's GT is |grid| (its
        TSDF-fusion signs are unreliable; reference trainer.py:446-453)."""
        from isdf_tpu_torch.data import sdf_util as SU
        cfg = self.cfg
        sdf_file = os.path.join(cfg.gt_sdf_dir, "1cm", "sdf.npy")
        tr_file = os.path.join(cfg.gt_sdf_dir, "1cm", "transform.txt")
        if not os.path.exists(sdf_file):
            return
        grid = np.load(sdf_file)
        if cfg.dataset_format == "ScanNet":
            grid = np.abs(grid)
        transform = SU.load_transform_txt(tr_file)
        interp = SU.sdf_interpolator(grid, transform)
        self.gt_sdf_fn = lambda pts: SU.eval_sdf_interp(
            interp, pts, handle_oob="fill", oob_val=np.nan)

    # ------------------------------------------------------------------
    # scene frame

    def set_scene_properties(self, bounds_transform: np.ndarray,
                             extents: np.ndarray):
        """The normalised training domain (reference trainer.py:103-155):
        bounds_transform maps the unit-box frame to the world, extents is
        the box size; grid_pc spans [-1, 1]^3 * scene_scale through that
        transform."""
        self.bounds_transform_np = np.asarray(bounds_transform, np.float32)
        self.inv_bounds_transform_np = np.linalg.inv(
            self.bounds_transform_np).astype(np.float32)
        self.scene_scale_np = (np.asarray(extents, np.float32)
                               / np.float32(2.0 * 0.9))
        self.transform_dev = torch.as_tensor(self.inv_bounds_transform_np,
                                             device=self.device)
        self.scene_extents_np = np.asarray(extents, np.float32)
        self._grid_pc = None

    @property
    def grid_pc(self):
        """The meshing grid [grid_dim^3, 3] on the trainer's device, built
        at first use (96 MB at grid_dim 200)."""
        if self._grid_pc is None:
            self._grid_pc = G.make_3D_grid(
                (-1.0, 1.0), self.grid_dim,
                transform=torch.as_tensor(self.bounds_transform_np,
                                          device=self.device),
                scale=torch.as_tensor(self.scene_scale_np,
                                      device=self.device),
                device=self.device).reshape(-1, 3)
        return self._grid_pc

    # ------------------------------------------------------------------
    # ingestion

    def get_latest_frame_id(self) -> int:
        return int(self.tot_step_time * self.cfg.fps)

    def _compute_normals(self, depth):
        d = torch.where(depth == 0.0, torch.nan, depth)
        pc = G.pointcloud_from_depth(d, self.fx, self.fy, self.cx, self.cy)
        return G.estimate_pointcloud_normals(pc)

    def get_data(self, idxs) -> List[FrameData]:
        out = []
        for idx in idxs:
            s = self.dataset[idx]
            depth = np.asarray(s["depth"], np.float32)
            normals = None
            if self.cfg.do_normal:
                normals = self._compute_normals(torch.as_tensor(
                    depth, device=self.device))
            out.append(FrameData(
                frame_id=int(idx), image=s.get("image"), depth=depth,
                T_WC=np.asarray(s["T"], np.float32), normals=normals,
                T_WC_gt=s.get("T_gt")))
        return out

    def add_frame(self, frame: FrameData):
        """Reference add_frame semantics (trainer.py:574-581): freeze the
        net on keyframe promotion; replace the newest arena row unless it
        was a keyframe; reset the per-frame iteration budget."""
        if self.last_is_keyframe:
            self.frozen_params = M.copy_params(self.params)
        replace = not self.last_is_keyframe and len(self.frames) > 0
        if not replace and self.buffer.count >= self.cfg.kf_buffer_size:
            if self.cfg.kf_eviction == "lowest":
                self.buffer = BUF.evict_lowest_priority(self.buffer)
            else:
                raise RuntimeError(
                    f"keyframe arena full ({self.cfg.kf_buffer_size}); "
                    "raise tpu.kf_buffer_size or set tpu.kf_eviction="
                    "'lowest' for longer sequences")
        # the host mirror keeps no normals: the arena holds them
        self.frames.add(dataclasses.replace(frame, normals=None),
                        replace=replace)
        normals = frame.normals
        if self.buffer.normals is not None and normals is None:
            normals = torch.zeros((self.H, self.W, 3), device=self.device)
        self.buffer = BUF.add_frame(
            self.buffer, torch.as_tensor(frame.depth, device=self.device),
            torch.as_tensor(frame.T_WC, device=self.device),
            None if normals is None else torch.as_tensor(
                normals, device=self.device),
            frame.frame_id, replace)
        self.steps_since_frame = 0
        self.last_is_keyframe = False
        self.optim_frames = self.cfg.iters_per_frame
        self.noise_std = self.cfg.noise_frame

    # ------------------------------------------------------------------
    # keyframe state machine (reference trainer.py:586-650)

    def is_keyframe(self, frame: FrameData) -> bool:
        is_kf, prop = self.fns.is_keyframe(
            self.frozen_params,
            torch.as_tensor(frame.depth, device=self.device),
            torch.as_tensor(frame.T_WC, device=self.device),
            self.transform_dev, self._kf_gen, self.noise_std)
        # the share of sampled pixels the frozen map already renders within
        # threshold at the frame's current pose: the pose tracker's drift
        # evidence (should_refine_pose)
        self._last_kf_prop = float(prop)
        return bool(is_kf)

    def should_refine_pose(self) -> bool:
        """Run a pose burst only on drift evidence: skip it when the latest
        keyframe check found at least cfg.pose_skip_prop of its pixels
        already rendered within threshold (isdf_tpu trainer.py:422-432);
        pose_skip_prop <= 0 always refines."""
        if self.cfg.pose_skip_prop <= 0.0:
            return True
        return self._last_kf_prop < self.cfg.pose_skip_prop

    def check_keyframe_latest(self) -> bool:
        """Whether to add a new frame (reference trainer.py:622-650)."""
        add_new_frame = False
        if self.last_is_keyframe:
            add_new_frame = True
        else:
            self.last_is_keyframe = self.is_keyframe(self.frames[-1])
            if len(self.frames) >= 2:
                time_since_kf = (self.tot_step_time
                                 - self.frames[-2].frame_id / self.cfg.fps)
                if time_since_kf > 5.0 and not self.cfg.live:
                    self.last_is_keyframe = True
            if self.last_is_keyframe:
                self.optim_frames = self.cfg.iters_per_kf
                self.noise_std = self.cfg.noise_kf
            else:
                add_new_frame = True
        return add_new_frame

    # ------------------------------------------------------------------
    # optimisation

    def run_steps(self, n_steps: int) -> Dict[str, np.ndarray]:
        """Run ``n_steps`` optimisation steps; advance the sim clock by the
        bundle's device time (scaled by 1/frac_time_perception)."""
        clock = BundleClock(self.device)
        scalars = self.fns.train_bundle(
            self.params, self.opt_state, self.buffer, self.transform_dev,
            self._bundle_seed, float(self.noise_std), n_steps=n_steps,
            lr_scale=float(self.lr_scale), tail=bool(self.tail_mode),
            step0=self.steps_taken)
        clock.stop()
        names = sorted(scalars)
        stacked = torch.stack([scalars[k] for k in names]).cpu().numpy()
        out = {k: stacked[i] for i, k in enumerate(names)}
        measured = clock.seconds()
        dt = pinned_dt(n_steps, measured, self._per_step_device_s,
                       self._bill_exact)
        self._bill(dt, n_steps, measured)
        out["step_time_ms"] = np.full(n_steps, 1e3 * dt / n_steps)
        return out

    def _bill(self, dt: float, n_steps: int, measured: float):
        """Book ``n_steps`` steps that took ``dt`` billed seconds
        (``measured`` seconds on the clock): the sim clock, the step
        counters and the rolling timer. Trainer.run_steps and the
        multi-scene stepper (parallel/multi_scene.py) both book here."""
        billed = dt / self.cfg.frac_time_perception
        if self.cfg.step_rate_cap > 0:
            # bill each step at least 1/cap perception-seconds
            billed = max(billed, n_steps / self.cfg.step_rate_cap)
        self.tot_step_time += billed
        self.measured_s += measured
        self.steps_since_frame += n_steps
        self.steps_taken += n_steps
        self.step_timer.add("train", dt, n_steps)

    def perf_summary(self) -> Dict[str, float]:
        return self.step_timer.summary()

    def step(self):
        """Single-step API. Returns (losses dict of floats, step_time_ms)."""
        s = self.run_steps(1)
        losses = {k: float(v[0]) for k, v in s.items()
                  if k != "step_time_ms"}
        return losses, float(s["step_time_ms"][0])

    # ------------------------------------------------------------------
    # queries

    def _chunked_eval(self, pts, fn, out_tail):
        """A query over chunks of chunk_size points on the device, gathered
        there and fetched once (isdf_tpu trainer.py:586-611). ``pts``:
        numpy or a tensor [N, 3]."""
        x = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        if x.shape[0] == 0:
            return np.zeros((0,) + out_tail, np.float32)
        out = [fn(self.params, x[i:i + self.chunk_size], self.transform_dev)
               for i in range(0, x.shape[0], self.chunk_size)]
        return torch.cat(out).cpu().numpy()

    def sdf_fn(self, pts) -> np.ndarray:
        """Chunked SDF query [N, 3] -> [N], numpy out (reference
        trainer.py:2066-2070)."""
        return self._chunked_eval(pts, self.fns.eval_sdf, ())

    def grad_fn(self, pts) -> np.ndarray:
        """Chunked spatial-gradient query [N, 3] -> [N, 3], numpy out."""
        return self._chunked_eval(pts, self.fns.eval_sdf_grad, (3,))

    def get_sdf_grid(self) -> np.ndarray:
        """Dense SDF grid [grid_dim]^3 over grid_pc (reference
        trainer.py:1426-1444)."""
        return self.sdf_fn(self.grid_pc).reshape(
            self.grid_dim, self.grid_dim, self.grid_dim)

    def get_sdf_grid_sparse(self, stride: int = 2, safety: float = 2.0):
        """Coarse-to-fine SDF grid for meshing (isdf_tpu trainer.py:627-688):
        a stride-subsampled lattice first, then the fine points inside the
        coarse cells that can hold the zero level set.

        Every point of a cell lies within half the cell diagonal of a
        corner, so a (near) 1-Lipschitz SDF cannot cross zero in a cell
        whose smallest corner |sdf| exceeds diag / 2; cells above
        safety * diag / 2 are skipped and filled with the nearest coarse
        value (of the right sign by the same argument). Every fine cell
        with a crossing lies in an active coarse cell, so the mesh equals
        the dense grid's. The points are gathered on the device and each
        pass is one chunked query with one fetch.

        Returns (grid [dim]^3 numpy, evaluated fraction)."""
        dim = self.grid_dim
        pc = self.grid_pc.reshape(dim, dim, dim, 3)
        ci = np.arange(0, dim, stride)
        if ci[-1] != dim - 1:
            ci = np.append(ci, dim - 1)
        nc = len(ci)
        cit = torch.as_tensor(ci, device=self.device)
        coarse = self.sdf_fn(pc[cit][:, cit][:, :, cit].reshape(-1, 3)
                             ).reshape(nc, nc, nc)

        # per-cell world diagonal (index gap x world spacing per axis; the
        # rotation of bounds_transform keeps lengths)
        gaps = np.diff(ci).astype(np.float32)
        sp = 2.0 * self.scene_scale_np / (dim - 1)
        diag = np.sqrt((gaps[:, None, None] * sp[0]) ** 2
                       + (gaps[None, :, None] * sp[1]) ** 2
                       + (gaps[None, None, :] * sp[2]) ** 2)
        a = np.abs(coarse)
        corner_min = np.minimum.reduce([
            a[i:i + nc - 1, j:j + nc - 1, k:k + nc - 1]
            for i in (0, 1) for j in (0, 1) for k in (0, 1)])
        active_cell = corner_min <= safety * diag * 0.5

        # cell activity -> point activity: coarse cell j covers the fine
        # indices ci[j]..ci[j+1] inclusive, by per-axis incidence
        inc = np.zeros((dim, nc - 1), np.float32)
        for j in range(nc - 1):
            inc[ci[j]:ci[j + 1] + 1, j] = 1.0
        m = np.tensordot(inc, active_cell.astype(np.float32), (1, 0))
        m = np.tensordot(inc, m, (1, 1))
        m = np.tensordot(inc, m, (1, 2))
        mask = m.transpose(2, 1, 0) > 0.0

        nn = np.abs(np.arange(dim)[:, None] - ci[None, :]).argmin(axis=1)
        out = coarse[np.ix_(nn, nn, nn)].astype(np.float32)
        n_active = int(mask.sum())
        if n_active:
            out[mask] = self.sdf_fn(
                pc[torch.as_tensor(mask, device=self.device)])
        return out, n_active / float(dim ** 3)

    # ------------------------------------------------------------------
    # evals, meshing and persistence

    def _cached_scene(self):
        from isdf_tpu_torch.data.datasets import SceneCache
        cache = getattr(self, "_scene_cache", None)
        if cache is None:
            cache = self._scene_cache = SceneCache(self.dataset, skip=5)
        return cache

    def eval_fixed(self, t: float = None):
        """The fixed-point protocol at timestamp t (reference
        trainer.py:2080-2088); pops the next pending timestamp when t is
        None."""
        from isdf_tpu_torch.eval.eval_pts import fixed_pts_eval

        if t is None:
            t = self.eval_times.pop(0)
        n_seen = min(max(int(t * self.cfg.fps), 1), len(self.dataset))
        sample = self._cached_scene()[np.arange(n_seen)]
        obj_bounds = None
        if self.cfg.seq_dir:
            f = os.path.join(self.cfg.seq_dir, "obj_bounds.txt")
            if os.path.exists(f):
                from isdf_tpu_torch.eval.objects import load_obj_bounds
                obj_bounds = load_obj_bounds(f)
        return fixed_pts_eval(
            self.sdf_fn, t, self.eval_pts_dir, sample["depth"], sample["T"],
            self.dirs_C.cpu().numpy(), self.gt_sdf_fn,
            self.cfg.dataset_format, grad_fn=self.grad_fn,
            obj_bounds=obj_bounds, samples=self.cfg.eval_samples,
            eval_pts_root=self.cfg.eval_pts_root, seq_dir=self.cfg.seq_dir)

    def eval_sdf(self, samples: int = 200000, visible_region: bool = True):
        """The online SDF eval (reference trainer.py:1819-1866)."""
        from isdf_tpu_torch.eval.protocol import eval_sdf
        return eval_sdf(self, samples=samples, visible_region=visible_region)

    def _seq_file(self, name: str):
        f = (os.path.join(self.cfg.seq_dir, name) if self.cfg.seq_dir
             else None)
        return f if f and os.path.exists(f) else None

    def eval_object_sdf(self, samples: int = 10000):
        """Per-object SDF L1 (reference trainer.py:1955-2008); needs
        obj_bounds.txt in the sequence directory, else None."""
        from isdf_tpu_torch.eval.objects import (eval_object_sdf,
                                                 load_obj_bounds)
        f = self._seq_file("obj_bounds.txt")
        return (None if f is None else
                eval_object_sdf(self, load_obj_bounds(f), samples=samples))

    def eval_traj_cost(self, t_ahead: float = 5.0):
        """CHOMP cost along the upcoming GT trajectory (reference
        trainer.py:2010-2052); needs traj.txt in the sequence directory,
        else None."""
        from isdf_tpu_torch.eval.objects import eval_traj_cost
        f = self._seq_file("traj.txt")
        return (None if f is None else
                eval_traj_cost(self, np.loadtxt(f), t_ahead=t_ahead))

    def eval_mesh(self, samples: int = 200000):
        """Mesh accuracy and completion against the GT mesh (reference
        trainer.py:2054-2064)."""
        from isdf_tpu_torch.eval.protocol import eval_mesh
        return eval_mesh(self, samples=samples)

    def update_scene_bounds_from_observations(self):
        """Fit the training domain to the observed pointcloud where no GT
        scene bounds exist (reference trainer.py:1514-1516)."""
        from isdf_tpu_torch.vis.mesh_export import observed_pointcloud
        pc = observed_pointcloud(self)
        if len(pc) < 100:
            return
        T_scene_to_box, extents = G.oriented_bounds(pc)
        self.set_scene_properties(
            np.linalg.inv(T_scene_to_box).astype(np.float32),
            extents.astype(np.float32))

    def mesh_rec(self, crop_mesh_with_pc: bool = True):
        """The reconstructed mesh (vertices, faces) (reference
        trainer.py:1500-1542)."""
        from isdf_tpu_torch.vis.mesh_export import reconstruct_mesh
        if not self.gt_scene and self.incremental:
            self.update_scene_bounds_from_observations()
        return reconstruct_mesh(self, crop_mesh_with_pc=crop_mesh_with_pc)

    def write_mesh(self, filename: str):
        from isdf_tpu_torch.vis.mesh_export import write_mesh
        return write_mesh(self, filename)

    def write_slices(self, save_path: str, prefix: str = "", **kw):
        """SDF slice PNGs (vis/slices.py::write_slices)."""
        from isdf_tpu_torch.vis.slices import write_slices
        return write_slices(self, save_path, prefix=prefix, **kw)

    def save_checkpoint(self, path: str, step: int = 0):
        from isdf_tpu_torch.utils import checkpoint as CK
        CK.save_checkpoint(path, self, step=step)

    def load_checkpoint(self, path: str):
        """Load a full-state .npz (either package's), or a reference torch
        .pth / .pt (weights only, reference trainer.py:441-444)."""
        from isdf_tpu_torch.utils import checkpoint as CK
        if path.endswith((".pth", ".pt")):
            self.params = CK.load_reference_state_dict(path, self.params,
                                                       self.model)
            self.frozen_params = M.copy_params(self.params)
            return None
        return CK.load_checkpoint(path, self)

    # ------------------------------------------------------------------
    # pose refinement (engine/pose.py)

    def refine_poses_step(self, n_frames: int = 5, n_steps: int = 1):
        """One pose burst of ``n_steps`` iterations over the newest
        ``n_frames`` arena rows; updates self.pose_state (fold it in with
        apply_pose_corrections). The burst is timed like a bundle: CUDA
        events on the card, the host clock on the CPU
        (``_last_burst_s``). Returns the last iteration's loss."""
        if self.pose_state is None:
            raise RuntimeError("enable model.refine_poses in the config")
        n = self.buffer.count
        rows = torch.arange(max(n - n_frames, 0), max(n, 1),
                            device=self.device)
        clock = BundleClock(self.device)
        self.pose_state, losses = self._pose_step(
            self.params, self.pose_state, self.buffer.depth[rows],
            self.buffer.T_WC[rows], rows, self.fns.dirs, self.transform_dev,
            self._pose_gen, n_steps=n_steps)
        clock.stop()
        ls = losses.cpu().numpy()   # [n_steps + 1], the pre-burst loss first
        self._last_burst_s = clock.seconds()
        self._last_burst_rel_improve = float(
            (ls[0] - ls[-1]) / max(ls[0], 1e-9))
        return float(ls[-1])

    def apply_pose_corrections(self):
        """Fold the twists into the arena poses (T_WC <- exp(xi) T_WC) and
        zero them, so the step, renders and evals read corrected poses
        (isdf_tpu trainer.py:836-871). The newest frame's host copy gets
        its corrected pose too: the keyframe test and meshing read it.

        A burst whose loss fell by less than cfg.pose_min_rel_improve (as
        a fraction) carries map bias rather than drift: its twists are
        dropped without folding."""
        tw = self.pose_state.twists
        rel = getattr(self, "_last_burst_rel_improve", None)
        if rel is not None and rel < self.cfg.pose_min_rel_improve:
            tw.zero_()
            return
        self.buffer.T_WC.copy_(P.corrected_poses(tw, self.buffer.T_WC))
        tw.zero_()
        n = self.buffer.count
        if n > 0 and len(self.frames) > 0:
            self.frames.frames[-1] = dataclasses.replace(
                self.frames.frames[-1],
                T_WC=self.buffer.T_WC[n - 1].cpu().numpy())
