"""Native asset loaders (isdf_tpu/data/assets.py): GLB (binary glTF 2.0)
meshes and URDF forward kinematics, on numpy and the standard library
(trimesh and urdfpy are not dependencies).

Capability-matched to the reference's ReplicaCAD tooling
(isdf/datasets/replicaCAD_gt_sdf.py:34-78): GLB stage/object meshes via
trimesh.load, articulated furniture via urdfpy's URDF.load + link_fk with
an optional joint configuration. Geometry only — materials/skins/
animations are ignored (the SDF composer needs triangles).
"""

from __future__ import annotations

import json
import os
import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

Mesh = Tuple[np.ndarray, np.ndarray]  # (verts [N,3] f32, faces [M,3] i32)

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942
_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
          5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_accessor(gltf: Dict, binbuf: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_CTYPE[acc["componentType"]])
    ncomp = _NCOMP[acc["type"]]
    count = acc["count"]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0) or dtype.itemsize * ncomp
    if stride == dtype.itemsize * ncomp:
        out = np.frombuffer(binbuf, dtype, count * ncomp, start)
        return out.reshape(count, ncomp)
    rows = np.empty((count, ncomp), dtype)
    for i in range(count):
        rows[i] = np.frombuffer(binbuf, dtype, ncomp, start + i * stride)
    return rows


def _node_transform(node: Dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    T = np.eye(4)
    if "scale" in node:
        T[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:        # glTF quaternion order: x, y, z, w
        x, y, z, w = node["rotation"]
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]])
        T[:3, :3] = R @ T[:3, :3]
    if "translation" in node:
        T[:3, 3] = node["translation"]
    return T


def load_glb(path: str) -> Mesh:
    """All triangle primitives of a .glb, world-posed by the node
    hierarchy, concatenated into one (verts, faces) mesh."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise ValueError(f"{path}: not a GLB container")
    off = 12
    gltf, binbuf = None, b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8: off + 8 + clen]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk)
        elif ctype == _CHUNK_BIN:
            binbuf = chunk
        off += 8 + clen
    if gltf is None:
        raise ValueError(f"{path}: missing JSON chunk")

    verts_all: List[np.ndarray] = []
    faces_all: List[np.ndarray] = []

    def _emit(mesh_ix: int, T: np.ndarray):
        for prim in gltf["meshes"][mesh_ix]["primitives"]:
            if prim.get("mode", 4) != 4:      # triangles only
                continue
            pos = _read_accessor(gltf, binbuf, prim["attributes"]["POSITION"]
                                 ).astype(np.float64)
            pos = pos @ T[:3, :3].T + T[:3, 3]
            if "indices" in prim:
                idx = _read_accessor(gltf, binbuf, prim["indices"]
                                     ).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            base = sum(len(v) for v in verts_all)
            verts_all.append(pos)
            faces_all.append(idx.reshape(-1, 3) + base)

    def _walk(node_ix: int, T: np.ndarray):
        node = gltf["nodes"][node_ix]
        T = T @ _node_transform(node)
        if "mesh" in node:
            _emit(node["mesh"], T)
        for c in node.get("children", []):
            _walk(c, T)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    roots = scene.get("nodes")
    if roots is None:                          # no scene: pose-less meshes
        for m in range(len(gltf.get("meshes", []))):
            _emit(m, np.eye(4))
    else:
        for r in roots:
            _walk(r, np.eye(4))
    if not verts_all:
        raise ValueError(f"{path}: no triangle geometry")
    return (np.concatenate(verts_all).astype(np.float32),
            np.concatenate(faces_all).astype(np.int32))


# ---------------------------------------------------------------------------
# URDF forward kinematics (reference: urdfpy URDF.load + link_fk,
# replicaCAD_gt_sdf.py:50-78)
# ---------------------------------------------------------------------------

def _rpy_matrix(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _origin_T(el: Optional[ET.Element]) -> np.ndarray:
    T = np.eye(4)
    if el is None:
        return T
    xyz = [float(v) for v in el.get("xyz", "0 0 0").split()]
    rpy = [float(v) for v in el.get("rpy", "0 0 0").split()]
    T[:3, :3] = _rpy_matrix(rpy)
    T[:3, 3] = xyz
    return T


def _axis_rotation(axis, angle) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / max(np.linalg.norm(a), 1e-12)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    return T


def load_urdf_meshes(urdf_file: str, mesh_loader,
                     joint_cfg: Optional[Dict[str, float]] = None,
                     use_collision: bool = False) -> List[Mesh]:
    """Link meshes posed by forward kinematics at the given joint values
    (default zeros — the reference's default joint state when no cfg is
    passed, replicaCAD_gt_sdf.py:126-131).

    mesh_loader(path) -> (verts, faces); mesh filenames resolve relative
    to the URDF's directory.
    """
    joint_cfg = joint_cfg or {}
    root_dir = os.path.dirname(os.path.abspath(urdf_file))
    robot = ET.parse(urdf_file).getroot()

    links = {l.get("name"): l for l in robot.findall("link")}
    joints = robot.findall("joint")
    children = {j.find("child").get("link") for j in joints}
    roots = [n for n in links if n not in children]

    # FK: T_child = T_parent @ origin @ motion(joint value)
    T_link: Dict[str, np.ndarray] = {r: np.eye(4) for r in roots}
    pending = list(joints)
    while pending:
        progressed = False
        for j in list(pending):
            parent = j.find("parent").get("link")
            if parent not in T_link:
                continue
            child = j.find("child").get("link")
            T = T_link[parent] @ _origin_T(j.find("origin"))
            jtype = j.get("type", "fixed")
            val = joint_cfg.get(j.get("name"), 0.0)
            if jtype in ("revolute", "continuous") and val != 0.0:
                axis = [float(v) for v in j.find("axis").get(
                    "xyz", "1 0 0").split()] if j.find("axis") is not None \
                    else [1, 0, 0]
                T = T @ _axis_rotation(axis, val)
            elif jtype == "prismatic" and val != 0.0:
                axis = [float(v) for v in j.find("axis").get(
                    "xyz", "1 0 0").split()] if j.find("axis") is not None \
                    else [1, 0, 0]
                Tp = np.eye(4)
                Tp[:3, 3] = val * np.asarray(axis, np.float64)
                T = T @ Tp
            T_link[child] = T
            pending.remove(j)
            progressed = True
        if not progressed:
            raise ValueError(f"{urdf_file}: disconnected joint graph")

    out: List[Mesh] = []
    tag = "collision" if use_collision else "visual"
    for name, link in links.items():
        for vis in link.findall(tag):
            geom = vis.find("geometry")
            mesh_el = geom.find("mesh") if geom is not None else None
            if mesh_el is None:
                continue
            fname = mesh_el.get("filename")
            fname = fname.replace("package://", "")
            path = fname if os.path.isabs(fname) else os.path.join(
                root_dir, fname)
            v, f = mesh_loader(path)
            v = np.asarray(v, np.float64)
            if mesh_el.get("scale"):
                v = v * np.asarray(
                    [float(s) for s in mesh_el.get("scale").split()])
            T = T_link[name] @ _origin_T(vis.find("origin"))
            v = v @ T[:3, :3].T + T[:3, 3]
            out.append((v.astype(np.float32), np.asarray(f, np.int32)))
    return out
