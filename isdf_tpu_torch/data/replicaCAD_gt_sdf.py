"""ReplicaCAD ground-truth SDF composer (isdf_tpu/data/replicaCAD_gt_sdf.py).

Reference: isdf/datasets/replicaCAD_gt_sdf.py — loads the habitat scene
instance config (stage + rigid object placements), voxelises every
component mesh into a shared grid and composes the full scene SDF as the
min over component SDFs (articulated furniture handled as extra rigid
parts at their default joint states).

The composer takes OBJ/PLY component meshes (utils/mesh3d) and GLB
(data/assets.py); the composition logic and output layout
(1cm/{sdf.npy, stage_sdf.npy, transform.txt}) match the reference, so the
training and eval stack reads them unchanged.

    python -m isdf_tpu_torch.data.replicaCAD_gt_sdf --scene_config S.json \
        --asset_root DIR --out_dir GT_DIR [--voxel 0.01]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from isdf_tpu_torch.data import sdf_util
from isdf_tpu_torch.utils import mesh3d


def _quat_to_R(q) -> np.ndarray:
    """Habitat quaternion [w, x, y, z] -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def transform_mesh(verts: np.ndarray, translation, rotation_q,
                   uniform_scale: float = 1.0) -> np.ndarray:
    """Instance placement: scale, rotate (habitat [w,x,y,z] quaternion),
    translate (reference get_transf_and_scale, replicaCAD_gt_sdf.py:17-47)."""
    R = _quat_to_R(rotation_q)
    return (verts * uniform_scale) @ R.T + np.asarray(translation)


def load_scene_instance(scene_config: str) -> Dict:
    """Parse a habitat *.scene_instance.json: stage name + object
    placements (reference replicaCAD_gt_sdf.py:147-188)."""
    with open(scene_config) as f:
        cfg = json.load(f)
    out = {"stage": cfg["stage_instance"]["template_name"], "objects": []}
    for o in cfg.get("object_instances", []):
        out["objects"].append({
            "template": o["template_name"],
            "translation": o.get("translation", [0, 0, 0]),
            "rotation": o.get("rotation", [1, 0, 0, 0]),
            "uniform_scale": o.get("uniform_scale", 1.0),
        })
    for o in cfg.get("articulated_object_instances", []):
        out["objects"].append({
            "template": o["template_name"],
            "translation": o.get("translation", [0, 0, 0]),
            "rotation": o.get("rotation", [1, 0, 0, 0]),
            "uniform_scale": o.get("uniform_scale", 1.0),
            "articulated": True,
        })
    return out


def grid_transform(bounds_min, voxel: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float32) * voxel
    T[3, 3] = 1.0
    T[:3, 3] = np.asarray(bounds_min, np.float32)
    return T


def compose_scene_sdf(
    stage_mesh: Tuple[np.ndarray, np.ndarray],
    object_meshes: List[Tuple[np.ndarray, np.ndarray]],
    voxel: float = 0.01,
    pad: float = 0.2,
) -> Dict[str, np.ndarray]:
    """Full GT SDF = min(stage SDF, each object SDF) on a shared 1cm grid
    (reference replicaCAD_gt_sdf.py:81-144). Returns
    {sdf, stage_sdf, transform}."""
    sv, sf = stage_mesh
    lo = sv.min(axis=0) - pad
    hi = sv.max(axis=0) + pad
    dims = np.ceil((hi - lo) / voxel).astype(int) + 1
    T = grid_transform(lo, voxel)

    stage_sdf = sdf_util.mesh_to_sdf(sv, sf, tuple(dims), T)
    sdf = stage_sdf.copy()
    for ov, of in object_meshes:
        obj = sdf_util.mesh_to_sdf(ov, of, tuple(dims), T)
        sdf = np.minimum(sdf, obj)
    return {"sdf": sdf, "stage_sdf": stage_sdf, "transform": T}


def write_gt_sdf_dir(out_dir: str, composed: Dict[str, np.ndarray],
                     mesh: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """Write the reference's gt_sdf_dir layout (trainer.py:205-210):
    <out>/1cm/{sdf.npy, stage_sdf.npy, transform.txt} [+ mesh.ply]."""
    d = os.path.join(out_dir, "1cm")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "sdf.npy"), composed["sdf"])
    np.save(os.path.join(d, "stage_sdf.npy"), composed["stage_sdf"])
    np.savetxt(os.path.join(d, "transform.txt"), composed["transform"])
    if mesh is not None:
        mesh3d.write_ply(os.path.join(out_dir, "mesh.ply"), *mesh)


def _load_any_mesh(path: str):
    """OBJ/PLY via utils/mesh3d; GLB via the native parser
    (data/assets.py — the reference uses trimesh.load here)."""
    if path.lower().endswith(".glb"):
        from isdf_tpu_torch.data.assets import load_glb
        return load_glb(path)
    return mesh3d.load_mesh(path)


def merge_meshes(meshes):
    """Concatenate (verts, faces) lists into one mesh (the reference's
    trimesh.util.concatenate over articulated links)."""
    vs, fs, base = [], [], 0
    for v, f in meshes:
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int64) + base)
        base += len(v)
    return np.concatenate(vs), np.concatenate(fs).astype(np.int32)


def main(scene_config: str, asset_root: str, out_dir: str,
         voxel: float = 0.01, joint_cfg: Optional[Dict] = None):
    """CLI pipeline: scene_instance.json + assets (OBJ/PLY/GLB, URDF for
    articulated furniture) -> gt_sdf dir (reference
    replicaCAD_gt_sdf.py:147-188). joint_cfg: {template_name:
    {joint_name: value}} poses articulated joints (default zeros)."""
    import glob as _glob

    inst = load_scene_instance(scene_config)
    joint_cfg = joint_cfg or {}

    def _find(name):
        for ext in (".glb", ".obj", ".ply"):
            for cand in (os.path.join(asset_root, name + ext),
                         os.path.join(asset_root, "objects", name + ext),
                         os.path.join(asset_root, "stages", name + ext)):
                if os.path.exists(cand):
                    return _load_any_mesh(cand)
        raise FileNotFoundError(
            f"asset {name} (glb/obj/ply) under {asset_root}")

    stage = _find(inst["stage"])
    objs = []
    for o in inst["objects"]:
        if o.get("articulated"):
            from isdf_tpu_torch.data.assets import load_urdf_meshes
            pats = [os.path.join(asset_root, "urdf", "*",
                                 o["template"] + ".urdf"),
                    os.path.join(asset_root, "urdf",
                                 o["template"] + ".urdf"),
                    os.path.join(asset_root, "*", o["template"] + ".urdf")]
            hits = [h for p in pats for h in _glob.glob(p)]
            if not hits:
                raise FileNotFoundError(
                    f"urdf for {o['template']} under {asset_root}")
            v, f = merge_meshes(load_urdf_meshes(
                hits[0], _load_any_mesh,
                joint_cfg=joint_cfg.get(o["template"])))
        else:
            v, f = _find(o["template"])
        objs.append((transform_mesh(v, o["translation"], o["rotation"],
                                    o.get("uniform_scale", 1.0)), f))

    composed = compose_scene_sdf(stage, objs, voxel=voxel)
    write_gt_sdf_dir(out_dir, composed, mesh=stage)
    return composed


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene_config", required=True)
    ap.add_argument("--asset_root", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--voxel", type=float, default=0.01)
    a = ap.parse_args()
    main(a.scene_config, a.asset_root, a.out_dir, a.voxel)
