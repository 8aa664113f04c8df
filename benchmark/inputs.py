"""The benchmark's inputs, made from the run's seed and handed alike to the
program and to the plain reference: a room, its depth views ray-cast on
the card, camera poses, the map's weights and a planner's query points.

The room follows the pattern of the port's synthetic scene (a box room,
two spheres and two boxes on its floor, an orbit of views around its
centre), rewritten here so that nothing of the program is imported. Every
seed gives a room of the same kind: the rays of every view hit a wall, so
the work of a step does not depend on the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the camera of the shipped configs (1200 x 680, f = 600 px)
CAM = dict(H=680, W=1200, fx=600.0, fy=600.0, cx=599.5, cy=339.5)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of a run's inputs."""
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of a run's inputs."""
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 1 << 62)))
    return g


class Room:
    """A box room (y points down, the floor at y = +extents[1] / 2) with
    two spheres and two boxes resting below the camera's orbit."""

    def __init__(self, seed: int):
        r = rng(seed, 1)
        self.extents = np.array([r.uniform(5.5, 7.0), r.uniform(2.8, 3.2),
                                 r.uniform(4.2, 5.0)], np.float32)
        self.center = np.zeros(3, np.float32)
        floor = float(self.extents[1]) / 2.0
        self.spheres, self.boxes = [], []
        for k in range(4):
            ang = 2 * math.pi * (k + r.uniform(0.1, 0.9)) / 4
            rad = r.uniform(0.6, 1.8)
            x = float(np.clip(rad * math.cos(ang), -self.extents[0] / 2 + 0.8,
                              self.extents[0] / 2 - 0.8))
            z = float(np.clip(rad * math.sin(ang), -self.extents[2] / 2 + 0.8,
                              self.extents[2] / 2 - 0.8))
            size = r.uniform(0.3, 0.5)
            if k % 2 == 0:
                self.spheres.append(((x, floor - size, z), size))
            else:
                self.boxes.append(((x, floor - size, z),
                                   (size, size, r.uniform(0.3, 0.5))))

    def bounds_transform(self) -> np.ndarray:
        """The unit-box frame of the training domain: the room's centre."""
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = self.center
        return T

    def poses(self, n: int, turns: float = 1.5) -> np.ndarray:
        """[n, 4, 4] float32 camera-to-world poses on an orbit of radius
        1.4 m at the room's mid height, each looking ahead and outward."""
        out = np.zeros((n, 4, 4), np.float32)
        for i in range(n):
            ang = 2 * math.pi * turns * i / max(n, 1)
            eye = self.center + np.array([1.4 * math.cos(ang), 0.0,
                                          1.4 * math.sin(ang)])
            tgt = self.center + np.array([2.5 * math.cos(ang + 0.9), 0.15,
                                          2.5 * math.sin(ang + 0.9)])
            out[i] = look_at(eye, tgt)
        return out

    @torch.no_grad()
    def render(self, poses: torch.Tensor, dirs_C: torch.Tensor,
               max_depth: float = 12.0, chunk: int = 16) -> torch.Tensor:
        """Ray-cast z-depth [F, H, W] of the views ``poses`` [F, 4, 4] (0
        where nothing is hit within max_depth), ``chunk`` views at a time:
        the nearest of the room's walls (seen from inside), the spheres and
        the boxes, in closed form. The rays' z-component in the camera is 1,
        so the distance along them is the z-depth."""
        out = []
        dev = poses.device
        lo = torch.as_tensor(self.center - self.extents / 2, device=dev)
        hi = torch.as_tensor(self.center + self.extents / 2, device=dev)
        for i in range(0, poses.shape[0], chunk):
            T = poses[i:i + chunk]
            o = T[:, None, None, :3, 3]
            d = torch.einsum("fij,hwj->fhwi", T[:, :3, :3], dirs_C)
            inv = 1.0 / torch.where(d == 0, 1e-12, d)
            # the room: the exit through its nearest wall
            t = torch.where(d > 0, (hi - o) * inv, (lo - o) * inv).amin(-1)
            for c, rad in self.spheres:
                oc = o - d.new_tensor(c)
                a = (d * d).sum(-1)
                b = (oc * d).sum(-1)
                disc = b * b - a * ((oc * oc).sum(-1) - rad * rad)
                near = (-b - disc.clamp(min=0).sqrt()) / a
                t = torch.where((disc >= 0) & (near > 0),
                                torch.minimum(t, near), t)
            for c, he in self.boxes:
                b_lo = d.new_tensor(c) - d.new_tensor(he)
                b_hi = d.new_tensor(c) + d.new_tensor(he)
                t1, t2 = (b_lo - o) * inv, (b_hi - o) * inv
                tn = torch.minimum(t1, t2).amax(-1)
                tf = torch.maximum(t1, t2).amin(-1)
                t = torch.where((tn <= tf) & (tn > 0), torch.minimum(t, tn), t)
            out.append(torch.where(t < max_depth, t, 0.0))
        return torch.cat(out)


def look_at(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """OpenCV-style camera-to-world pose: z towards the target."""
    eye, target, up = (np.asarray(v, float) for v in (eye, target, up))
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([x, y, z], axis=1)
    T[:3, 3] = eye
    return T


def layer_shapes(E: int, H: int, blocks: int):
    """[(fan_in, fan_out)] of the SDF MLP: in, mid1.., cat, mid2.., out."""
    return ([(E, H)] + [(H, H)] * blocks + [(H + E, H)]
            + [(H, H)] * blocks + [(H, 1)])


def make_weights(seed: int, E: int, H: int, blocks: int, device,
                 stream: int = 2):
    """The map's weights in the plain per-layer layout, [(w [fan_in,
    fan_out], b [fan_out])], made on ``device`` in two calls: Xavier-normal
    weights and U(-1/sqrt(fan_in), 1/sqrt(fan_in)) biases, the
    distributions the program draws its own from."""
    shapes = layer_shapes(E, H, blocks)
    g = torch_gen(seed, stream, device)
    zw = torch.randn(sum(fi * fo for fi, fo in shapes), generator=g,
                     device=device)
    ub = torch.rand(sum(fo for _, fo in shapes), generator=g, device=device)
    out, a, c = [], 0, 0
    for fi, fo in shapes:
        w = zw[a:a + fi * fo].reshape(fi, fo) * math.sqrt(2.0 / (fi + fo))
        b = (ub[c:c + fo] * 2.0 - 1.0) / math.sqrt(fi)
        out.append((w, b))
        a, c = a + fi * fo, c + fo
    return out


def as_tree(layers, blocks: int):
    """The per-layer weights as the JAX package's pytree of numpy arrays,
    the form models/sdf_mlp.py::params_from_jax takes."""
    d = [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
         for w, b in layers]
    return {"in": d[0], "mid1": d[1:1 + blocks], "cat": d[1 + blocks],
            "mid2": d[2 + blocks:2 + 2 * blocks], "out": d[2 + 2 * blocks]}


def ray_dirs_C(H, W, fx, fy, cx, cy, device):
    """Per-pixel camera-frame ray directions [H, W, 3] with z = 1."""
    c = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    r = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    x = ((c - cx) / fx).expand(H, W)
    y = ((r - cy) / fy).expand(H, W)
    return torch.stack((x, y, torch.ones((H, W), device=device)), dim=-1)


def query_points(seed: int, index: int, n: int, room: Room) -> np.ndarray:
    """Request ``index``'s [n, 3] float32 points, uniform in the room."""
    half = room.extents / 2.0
    u = rng(seed, 1000 + index).uniform(-1.0, 1.0, (n, 3))
    return (room.center + u * half).astype(np.float32)
