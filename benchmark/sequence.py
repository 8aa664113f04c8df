"""A ReplicaCAD-format sequence written from the seed, as the port's reader
reads the published one: ``traj.txt`` (one camera-to-world pose a row, 16
numbers), ``results/ndepth%06d.png`` (16-bit depth at depth_scale, with
depth noise) and ``results/frame%06d.png`` (8-bit colour), and the scene
mesh ``mesh.obj`` of the GT directory, which sets the training domain.

``distinct`` views of one closed orbit of the room are written; the
sequence repeats them (frame i shows view i mod distinct, as hard links),
so that a long sequence costs the disk only its distinct views.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import inputs as I


def png_bytes(img: np.ndarray) -> bytes:
    """A PNG of a uint16 [H, W] (grey, 16 bits) or uint8 [H, W, 3] (RGB)
    image, every row under the Up filter, zlib level 1."""
    if img.dtype == np.uint16:
        H, W = img.shape
        raw = img.astype(">u2").view(np.uint8).reshape(H, W * 2)
        depth, ctype = 16, 0
    else:
        H, W, _ = img.shape
        raw = np.ascontiguousarray(img, np.uint8).reshape(H, W * 3)
        depth, ctype = 8, 2
    up = raw.copy()
    up[1:] = raw[1:] - raw[:-1]           # uint8 arithmetic wraps mod 256
    rows = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def noisy_depth_u16(depth: torch.Tensor, gen, depth_scale: float):
    """Depth in metres [F, H, W] -> the sensor's uint16 at depth_scale, with
    axial noise growing with range (sigma = 1.2 mm + 1.9 mm (z - 0.4)^2,
    the Kinect model of Nguyen et al. 2012); 0 stays 0 (no return)."""
    sig = 0.0012 + 0.0019 * (depth - 0.4) ** 2
    z = depth + sig * torch.randn(depth.shape, generator=gen,
                                  device=depth.device)
    q = torch.round(z.clamp(min=0.0) * depth_scale).clamp(max=65535)
    return torch.where(depth > 0, q, 0.0).to(torch.int32).cpu().numpy() \
        .astype(np.uint16)


def colour(depth_u16: np.ndarray) -> np.ndarray:
    """A colour view [H, W, 3] uint8 shaded by range."""
    d = depth_u16.astype(np.float32) / 3276.75
    g = np.clip(255.0 * (1.0 - d / 8.0), 0, 255).astype(np.uint8)
    return np.stack([g, g // 2 + 64, 255 - g], axis=-1)


def box_obj(room: I.Room) -> str:
    """The room's box as an OBJ mesh (8 vertices, 12 triangles)."""
    lo = room.center - room.extents / 2
    hi = room.center + room.extents / 2
    v = [[(lo, hi)[i >> 2 & 1][0], (lo, hi)[i >> 1 & 1][1],
          (lo, hi)[i & 1][2]] for i in range(8)]
    f = [(1, 2, 4), (1, 4, 3), (5, 7, 8), (5, 8, 6), (1, 5, 6), (1, 6, 2),
         (3, 4, 8), (3, 8, 7), (1, 3, 7), (1, 7, 5), (2, 6, 8), (2, 8, 4)]
    return "".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v) + \
        "".join(f"f {a} {b} {c}\n" for a, b, c in f)


def write(root: str, room: I.Room, seed: int, cam: dict, distinct: int,
          n_frames: int, depth_scale: float, device, max_depth: float = 12.0,
          chunk: int = 16):
    """Write the sequence under ``root`` (``seq/`` and ``gt/``); returns
    (seq_dir, gt_dir, depth_u16 [distinct, H, W], poses [distinct, 4, 4])."""
    seq, gt = os.path.join(root, "seq"), os.path.join(root, "gt")
    res = os.path.join(seq, "results")
    os.makedirs(res)
    os.makedirs(gt)
    with open(os.path.join(gt, "mesh.obj"), "w") as f:
        f.write(box_obj(room))
    poses = room.poses(distinct, turns=1.0)
    with open(os.path.join(seq, "traj.txt"), "w") as f:
        for i in range(n_frames):
            f.write(" ".join(repr(float(x))
                             for x in poses[i % distinct].reshape(-1)) + "\n")
    dirs = I.ray_dirs_C(cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
                        cam["cy"], device)
    gen = I.torch_gen(seed, 4, device)
    out = np.zeros((distinct, cam["H"], cam["W"]), np.uint16)

    def put(i):
        with open(os.path.join(res, f"ndepth{i:06d}.png"), "wb") as f:
            f.write(png_bytes(out[i]))
        with open(os.path.join(res, f"frame{i:06d}.png"), "wb") as f:
            f.write(png_bytes(colour(out[i])))

    with ThreadPoolExecutor(4) as pool:
        jobs = []
        for a in range(0, distinct, chunk):
            T = torch.as_tensor(poses[a:a + chunk], device=device)
            d = room.render(T, dirs, max_depth)
            out[a:a + len(T)] = noisy_depth_u16(d, gen, depth_scale)
            jobs += [pool.submit(put, i) for i in range(a, a + len(T))]
        for j in jobs:
            j.result()
    for i in range(distinct, n_frames):
        for name in ("ndepth", "frame"):
            os.link(os.path.join(res, f"{name}{i % distinct:06d}.png"),
                    os.path.join(res, f"{name}{i:06d}.png"))
    return seq, gt, out, poses
