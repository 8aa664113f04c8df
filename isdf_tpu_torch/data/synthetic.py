"""Synthetic scenes with an analytic ground-truth SDF (isdf_tpu/data/
synthetic.py rebuilt in torch and numpy).

A box room with primitive obstacles, its exact signed distance function, a
sphere-traced depth camera and an orbit trajectory, emitting frames in the
reference sample format {"image", "depth", "T"}. Positive in observable
free space, negative inside obstacles and behind walls. Depth renders on
the dataset's device (the card in a real run).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from isdf_tpu_torch.ops import geometry as G


def sd_box(p, center, half_extents):
    """Exact box SDF (negative inside)."""
    q = (p - p.new_tensor(center)).abs() - p.new_tensor(half_extents)
    outside = q.clamp(min=0.0).norm(dim=-1)
    inside = q.max(dim=-1).values.clamp(max=0.0)
    return outside + inside


def sd_sphere(p, center, radius):
    return (p - p.new_tensor(center)).norm(dim=-1) - radius


class SyntheticScene:
    """Box room [extents] centred at ``center`` with obstacle primitives."""

    def __init__(self, extents: Tuple[float, float, float] = (6.0, 3.0, 4.0),
                 center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 spheres: Optional[List] = None, boxes: Optional[List] = None):
        self.extents = np.asarray(extents, np.float32)
        self.center = np.asarray(center, np.float32)
        if spheres is None:
            spheres = [((1.2, 0.7, 0.8), 0.5), ((-1.5, 0.9, -1.0), 0.4)]
        if boxes is None:
            boxes = [((0.0, 1.15, -0.8), (0.5, 0.35, 0.5)),
                     ((-1.8, 1.2, 1.2), (0.4, 0.3, 0.4))]
        self.spheres, self.boxes = spheres, boxes

    def sdf(self, p):
        """Exact free-space SDF at world points p [..., 3] (torch)."""
        d = -sd_box(p, self.center.tolist(), (self.extents / 2.0).tolist())
        for c, r in self.spheres:
            d = torch.minimum(d, sd_sphere(p, c, r))
        for c, he in self.boxes:
            d = torch.minimum(d, sd_box(p, c, he))
        return d

    def sdf_np(self, p):
        return self.sdf(torch.as_tensor(np.asarray(p, np.float32))).numpy()

    def gt_sdf_grid(self, dim: int = 64, pad: float = 0.0):
        """A regular GT grid [dim, dim, dim] over the room (+ pad) and its
        voxel -> world transform, like the reference's 1 cm GT npy and
        transform.txt pair (reference trainer.py:446-453)."""
        half = self.extents / 2.0 + pad
        lo = self.center - half
        hi = self.center + half
        axes = [np.linspace(lo[i], hi[i], dim, dtype=np.float32)
                for i in range(3)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        sdf = self.sdf_np(pts.reshape(-1, 3)).reshape(dim, dim, dim)
        transform = np.eye(4, dtype=np.float32)
        for i in range(3):
            transform[i, i] = (hi[i] - lo[i]) / (dim - 1)
        transform[:3, 3] = lo
        return sdf, transform

    @torch.no_grad()
    def render_depth(self, T_WC, dirs_C, max_depth: float = 12.0):
        """Sphere-traced z-depth for rays dirs_C [..., 3] (z convention);
        0 where no surface lies within max_depth."""
        origins, dirs_W = G.origin_dirs_W(T_WC, dirs_C)
        dnorm = dirs_W.norm(dim=-1)
        t = torch.full(dirs_W.shape[:-1], 0.05, dtype=torch.float32,
                       device=dirs_W.device)
        for _ in range(96):
            t = t + self.sdf(origins + dirs_W * t[..., None]) / dnorm
        hit = self.sdf(origins + dirs_W * t[..., None]).abs() < 1e-3
        return torch.where(hit & (t < max_depth), t, 0.0)


# named scenes used as benchmark "sequences"
SCENE_PRESETS = {
    "room_a": dict(extents=(6.0, 3.0, 4.5),
                   spheres=[((1.2, 0.7, 0.8), 0.5), ((-1.5, 0.9, -1.0), 0.4)],
                   boxes=[((0.0, 1.15, -0.8), (0.5, 0.35, 0.5)),
                          ((-1.8, 1.2, 1.2), (0.4, 0.3, 0.4))]),
    "room_b": dict(extents=(5.0, 2.8, 6.0),
                   spheres=[((0.8, 0.9, -1.6), 0.45),
                            ((-1.2, 0.6, 1.8), 0.35),
                            ((1.6, 0.5, 1.2), 0.3)],
                   boxes=[((-0.6, 1.1, -0.4), (0.6, 0.3, 0.4))]),
    "room_c": dict(extents=(7.0, 3.2, 3.5),
                   spheres=[((2.2, 0.8, 0.0), 0.55)],
                   boxes=[((-1.5, 1.2, 0.6), (0.5, 0.4, 0.5)),
                          ((0.5, 1.3, -0.9), (0.35, 0.25, 0.35)),
                          ((-2.6, 0.9, -0.8), (0.3, 0.6, 0.3))]),
}


def make_scene(preset: str = "room_a") -> SyntheticScene:
    return SyntheticScene(**SCENE_PRESETS[preset])


class SyntheticDataset:
    """Reference-format dataset over a SyntheticScene: frames on an orbit
    inside the room, looking inward-and-around, fps-timed like a
    ReplicaCAD trajectory. Samples are {"image" uint8 HxWx3, "depth"
    float32 HxW, "T" 4x4}.

    pose_noise_std > 0 reports each pose perturbed by a random SE(3)
    twist (std in rad and m; numpy draws from seed + 1234) while the depth
    is rendered from, and reported in "T_gt" as, the true pose: "iid"
    draws each frame's twist apart, "walk" accumulates the draws (tracker
    drift; isdf_tpu/data/synthetic.py:152-238)."""

    def __init__(self, scene: SyntheticScene, n_frames: int = 300,
                 H: int = 64, W: int = 96, hfov_deg: float = 70.0,
                 orbit_radius: float = 1.4, cam_height: float = 0.0,
                 max_depth: float = 12.0, seed: int = 0,
                 pose_noise_std: float = 0.0, pose_noise_mode: str = "iid",
                 device="cpu"):
        self.scene = scene
        self.n_frames = n_frames
        self.H, self.W = H, W
        self.fx = 0.5 * W / np.tan(np.deg2rad(hfov_deg) / 2)
        self.fy = self.fx
        self.cx, self.cy = (W - 1) / 2.0, (H - 1) / 2.0
        self.max_depth = max_depth
        self.device = torch.device(device)
        self._dirs_C = G.ray_dirs_C(H, W, self.fx, self.fy, self.cx, self.cy,
                                    device=self.device)
        c = scene.center
        self.poses = []
        for i in range(n_frames):
            ang = 2 * np.pi * i / max(n_frames, 1) * 1.5
            eye = c + np.array([orbit_radius * np.cos(ang), cam_height,
                                orbit_radius * np.sin(ang)])
            look_ang = ang + 0.9
            target = c + np.array([2.5 * np.cos(look_ang), 0.15,
                                   2.5 * np.sin(look_ang)])
            R, t = G.look_at(eye, target, up=np.array([0.0, -1.0, 0.0]))
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = t
            self.poses.append(T)
        self.pose_noise_std = float(pose_noise_std)
        self.noisy_poses = None
        if self.pose_noise_std > 0:
            rng = np.random.default_rng(seed + 1234)
            tw = rng.normal(0.0, self.pose_noise_std,
                            (n_frames, 6)).astype(np.float32)
            if pose_noise_mode == "walk":
                tw = np.cumsum(tw, axis=0)
            elif pose_noise_mode != "iid":
                raise ValueError(f"pose_noise_mode {pose_noise_mode!r}")
            pert = G.exp_se3(torch.from_numpy(tw)).numpy()
            self.noisy_poses = [pert[i] @ self.poses[i]
                                for i in range(n_frames)]
        self._cache = {}

    def __len__(self):
        return self.n_frames

    def camera(self):
        return dict(H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx,
                    cy=self.cy)

    def __getitem__(self, idx):
        idx = int(idx)
        if idx not in self._cache:
            T = self.poses[idx]
            depth = self.scene.render_depth(
                torch.as_tensor(T, device=self.device), self._dirs_C,
                self.max_depth).cpu().numpy()
            image = np.full((self.H, self.W, 3), 128, np.uint8)
            sample = {"image": image, "depth": depth.astype(np.float32),
                      "T": T}
            if self.noisy_poses is not None:
                sample["T"] = self.noisy_poses[idx]
                sample["T_gt"] = T
            self._cache[idx] = sample
        return self._cache[idx]

    def scene_bounds(self):
        """(bounds_transform [4,4], extents [3]) of the training domain."""
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = self.scene.center
        return T, self.scene.extents.copy()

    def sdf_mae(self, sdf_fn, n: int = 20000, seed: int = 0) -> float:
        """Mean |sdf_fn - analytic SDF| over ``n`` points drawn uniformly
        (numpy, fixed seed) in the room box inset by 5 cm: a quick check of
        the learned field over the whole room (the reference's protocol,
        eval/protocol.py, scores the visible region)."""
        rng = np.random.default_rng(seed)
        half = self.scene.extents / 2.0 - 0.05
        pts = (self.scene.center + rng.uniform(-1.0, 1.0, (n, 3)) * half
               ).astype(np.float32)
        return float(np.abs(np.asarray(sdf_fn(pts)) - self.scene.sdf_np(pts))
                     .mean())
