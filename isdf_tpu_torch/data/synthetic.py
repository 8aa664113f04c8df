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
    float32 HxW, "T" 4x4}. Reported-pose noise is not ported."""

    def __init__(self, scene: SyntheticScene, n_frames: int = 300,
                 H: int = 64, W: int = 96, hfov_deg: float = 70.0,
                 orbit_radius: float = 1.4, cam_height: float = 0.0,
                 max_depth: float = 12.0, device="cpu"):
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
            self._cache[idx] = {"image": image,
                                "depth": depth.astype(np.float32), "T": T}
        return self._cache[idx]

    def scene_bounds(self):
        """(bounds_transform [4,4], extents [3]) of the training domain."""
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = self.scene.center
        return T, self.scene.extents.copy()

    def sdf_mae(self, sdf_fn, n: int = 20000, seed: int = 0) -> float:
        """Mean |sdf_fn - analytic SDF| over ``n`` points drawn uniformly
        (numpy, fixed seed) in the room box inset by 5 cm. A simple check of
        the learned field; the reference's eval protocol is not ported."""
        rng = np.random.default_rng(seed)
        half = self.scene.extents / 2.0 - 0.05
        pts = (self.scene.center + rng.uniform(-1.0, 1.0, (n, 3)) * half
               ).astype(np.float32)
        return float(np.abs(np.asarray(sdf_fn(pts)) - self.scene.sdf_np(pts))
                     .mean())
