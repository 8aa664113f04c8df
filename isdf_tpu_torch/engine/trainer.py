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

Not ported yet: the mesh and voxblox evals, meshing, visualisation,
checkpoints, pose refinement, data parallelism and GT SDF grids from
disk; a config that asks for them raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from isdf_tpu_torch.data.frame_store import FrameData, FrameStore
from isdf_tpu_torch.engine import buffer as BUF
from isdf_tpu_torch.engine.step import StepFunctions, step_seed
from isdf_tpu_torch.models import fused_adamw
from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.ops import geometry as G
from isdf_tpu_torch.utils import nvcc
from isdf_tpu_torch.utils.config import Config, load_config
from isdf_tpu_torch.utils.device import resolve_device
from isdf_tpu_torch.utils.profiling import StepTimer


def check_supported(cfg: Config):
    """Raise on the parts of a config this port does not run yet."""
    missing = []
    if cfg.refine_poses:
        missing.append("model.refine_poses (pose refinement)")
    if cfg.data_parallel > 1:
        missing.append("tpu.data_parallel > 1")
    if cfg.mesh_eval or cfg.do_vox_comparison:
        missing.append("eval.mesh_eval / eval.do_vox_comparison")
    if cfg.save_checkpoints or cfg.save_slices or cfg.save_meshes:
        missing.append("save.save_checkpoints / save_slices / save_meshes")
    if missing:
        raise NotImplementedError(
            "not ported to isdf_tpu_torch yet: " + ", ".join(missing))


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
        cam = (dataset.camera() if hasattr(dataset, "camera") else dict(
            H=cfg.camera.h, W=cfg.camera.w, fx=cfg.camera.fx,
            fy=cfg.camera.fy, cx=cfg.camera.cx, cy=cfg.camera.cy))
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.dirs_C = G.ray_dirs_C(self.H, self.W, self.fx, self.fy,
                                   self.cx, self.cy, device=self.device)

        # ---- scene frame: the PE sees points in the unit-box frame
        # (reference trainer.py:103-155) ----
        if hasattr(dataset, "scene_bounds"):
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
            raise NotImplementedError(
                "not ported to isdf_tpu_torch yet: the scene frame from "
                "dataset.gt_sdf_dir/mesh.obj")
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

        # GT SDF for eval (numpy [N, 3] -> [N]); GT grids from disk are
        # not ported (reference trainer.py:446-453)
        self.gt_sdf_fn = getattr(dataset, "gt_sdf_fn", None)
        if self.gt_sdf_fn is None and hasattr(dataset, "scene"):
            self.gt_sdf_fn = dataset.scene.sdf_np

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
        is_kf, _ = self.fns.is_keyframe(
            self.frozen_params,
            torch.as_tensor(frame.depth, device=self.device),
            torch.as_tensor(frame.T_WC, device=self.device),
            self.transform_dev, self._kf_gen, self.noise_std)
        return bool(is_kf)

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
        cuda = self.device.type == "cuda"
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        scalars = self.fns.train_bundle(
            self.params, self.opt_state, self.buffer, self.transform_dev,
            self._bundle_seed, float(self.noise_std), n_steps=n_steps,
            lr_scale=float(self.lr_scale), tail=bool(self.tail_mode),
            step0=self.steps_taken)
        if cuda:
            ev1.record()
        names = sorted(scalars)
        stacked = torch.stack([scalars[k] for k in names]).cpu().numpy()
        out = {k: stacked[i] for i, k in enumerate(names)}
        measured = (ev0.elapsed_time(ev1) * 1e-3 if cuda
                    else time.perf_counter() - t0)
        self.measured_s += measured
        if self._per_step_device_s:
            dt = n_steps * self._per_step_device_s
            if not self._bill_exact:
                dt = min(dt, measured)
            dt = max(dt, 1e-5)
        else:
            dt = max(measured, 1e-5)
        billed = dt / self.cfg.frac_time_perception
        if self.cfg.step_rate_cap > 0:
            # bill each step at least 1/cap perception-seconds
            billed = max(billed, n_steps / self.cfg.step_rate_cap)
        self.tot_step_time += billed
        self.steps_since_frame += n_steps
        self.steps_taken += n_steps
        self.step_timer.add("train", dt, n_steps)
        out["step_time_ms"] = np.full(n_steps, 1e3 * dt / n_steps)
        return out

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
