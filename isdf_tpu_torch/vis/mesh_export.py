"""Mesh reconstruction and export (isdf_tpu/vis/mesh_export.py; reference
trainer.py:1500-1556).

The SDF grid is evaluated on the trainer's device (chunked, sparse by
default), the isosurface is extracted on the host (utils/mesh3d.py,
marching tetrahedra), optionally cropped to the faces near the observed
depth pointcloud (KD-tree) and written as binary PLY.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from isdf_tpu_torch.utils import mesh3d


def observed_pointcloud(trainer, skip: int = 16,
                        max_frames: int = 100) -> np.ndarray:
    """World-frame pointcloud of the stored frames' host depths, every
    ``skip``-th pixel (the reference backprojects 1/16-resolution caches,
    trainer.py:1504-1512)."""
    pts = []
    frames = trainer.frames.frames
    stride = max(1, len(frames) // max_frames)
    for f in frames[::stride]:
        d = f.depth[::skip, ::skip]
        rr, cc = np.meshgrid(np.arange(0, trainer.H, skip),
                             np.arange(0, trainer.W, skip), indexing="ij")
        valid = d > 0
        z = d[valid]
        x = z * (cc[valid] - trainer.cx) / trainer.fx
        y = z * (rr[valid] - trainer.cy) / trainer.fy
        pc_C = np.stack([x, y, z], axis=-1)
        pts.append(pc_C @ f.T_WC[:3, :3].T + f.T_WC[:3, 3])
    if not pts:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(pts).astype(np.float32)


def reconstruct_mesh(trainer, crop_mesh_with_pc: bool = True,
                     crop_dist: float = 0.25, orient: bool = False,
                     sparse: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices, faces) of the zero level set in world coordinates.

    ``sparse``: the coarse-to-fine grid (Trainer.get_sdf_grid_sparse),
    whose mesh equals the dense grid's; False queries the dense grid as
    the reference does (trainer.py:1426-1444)."""
    dim = trainer.grid_dim
    if sparse and dim >= 64:
        sdf, _ = trainer.get_sdf_grid_sparse()
    else:
        sdf = trainer.get_sdf_grid()

    verts_idx, faces = mesh3d.marching_tetrahedra(sdf, level=0.0)
    if len(verts_idx) == 0:
        return verts_idx, faces

    # index space [0, dim-1] -> box frame [-1, 1] * scale -> world
    local = (verts_idx / (dim - 1) * 2.0 - 1.0) * trainer.scene_scale_np
    T = trainer.bounds_transform_np
    verts = local @ T[:3, :3].T + T[:3, 3]

    if crop_mesh_with_pc and len(trainer.frames) > 0:
        pc = observed_pointcloud(trainer)
        if len(pc):
            verts, faces = mesh3d.crop_mesh_near_pc(verts, faces, pc,
                                                    crop_dist)

    if orient and len(faces):
        faces = mesh3d.orient_faces_outward(verts, faces, trainer.sdf_fn)
    return verts.astype(np.float32), faces


def write_mesh(trainer, filename: str, **kw):
    verts, faces = reconstruct_mesh(trainer, **kw)
    mesh3d.write_ply(filename, verts, faces)
    return verts, faces
