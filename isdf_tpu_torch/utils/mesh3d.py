"""Minimal triangle-mesh toolkit (numpy; isdf_tpu/utils/mesh3d.py) — in
place of trimesh and skimage.

trimesh and scikit-image are not dependencies of the port, so the mesh
capabilities the reference gets from them are implemented here:
  * isosurface extraction — marching TETRAHEDRA (each cell split into 6
    tets; 16 sign cases derived per tet, no lookup tables), vectorised
    over active cells. Replaces skimage.measure.marching_cubes as used by
    the reference (isdf/visualisation/draw3D.py:111-160).
  * area-weighted surface sampling (trimesh.sample.sample_surface,
    reference isdf/eval/metrics.py:62-73).
  * OBJ / PLY read + binary PLY write (trimesh.load / export_ply,
    reference trainer.py:80-82, 1544-1556).
  * vertex/face utilities for pointcloud-distance cropping
    (reference trainer.py:1527-1533).
"""

from __future__ import annotations

import itertools
import struct
from typing import Optional, Tuple

import numpy as np

# the 6 tetrahedra of a unit cell, as corner indices into the cube corner
# ordering c = (dx, dy, dz) bit-packed as dx*4 + dy*2 + dz
_CUBE_CORNERS = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
], dtype=np.int32)
# a standard 6-tet decomposition sharing the main diagonal 0-7
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], dtype=np.int32)


def marching_tetrahedra(
    sdf: np.ndarray,
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    prefer_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of a dense grid.

    Returns (vertices [V, 3] in world units = origin + index * spacing,
    faces [F, 3] int32). Faces are oriented so normals point towards
    positive SDF. Uses the C++ core (csrc/marching_tets.cpp, utils/native.py)
    when it builds; the numpy path below is the fallback and
    the cross-check oracle.
    """
    sdf = np.asarray(sdf, np.float32)
    if prefer_native:
        from isdf_tpu_torch.utils.native import marching_tets_native
        tris = marching_tets_native(sdf, level)
        if tris is not None:
            if len(tris) == 0:
                return (np.zeros((0, 3), np.float32),
                        np.zeros((0, 3), np.int32))
            return _weld(tris, spacing, origin)
    D0, D1, D2 = sdf.shape
    f = sdf - np.float32(level)

    # active cells: sign change among the 8 corners
    s = f > 0
    pos_count = np.zeros((D0 - 1, D1 - 1, D2 - 1), np.int8)
    for dx, dy, dz in _CUBE_CORNERS:
        pos_count += s[dx:D0 - 1 + dx, dy:D1 - 1 + dy, dz:D2 - 1 + dz]
    active = np.argwhere((pos_count > 0) & (pos_count < 8))  # [A, 3]
    if active.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # corner values/coords for the active cells
    corner_vals = np.stack([
        f[active[:, 0] + dx, active[:, 1] + dy, active[:, 2] + dz]
        for dx, dy, dz in _CUBE_CORNERS], axis=1)           # [A, 8]
    corner_pos = (active[:, None, :] + _CUBE_CORNERS[None, :, :]
                  ).astype(np.float32)                       # [A, 8, 3]

    tris = []
    for tet in _TETS:
        v = corner_vals[:, tet]                              # [A, 4]
        p = corner_pos[:, tet]                               # [A, 4, 3]
        inside = v <= 0
        n_in = inside.sum(1)

        def edge_pt(mask_a, ia, ib):
            """Zero crossing on edge (ia, ib) for the selected tets."""
            va, vb = v[mask_a, ia], v[mask_a, ib]
            t = va / (va - vb)
            return p[mask_a, ia] + t[:, None] * (p[mask_a, ib] - p[mask_a, ia])

        # case: exactly one corner inside -> one triangle
        for ci in range(4):
            m = (n_in == 1) & inside[:, ci]
            if not m.any():
                continue
            others = [o for o in range(4) if o != ci]
            e = [edge_pt(m, ci, o) for o in others]
            tris.append(np.stack(e, axis=1))

        # case: exactly one corner outside -> one triangle (flipped)
        for ci in range(4):
            m = (n_in == 3) & (~inside[:, ci])
            if not m.any():
                continue
            others = [o for o in range(4) if o != ci]
            e = [edge_pt(m, ci, o) for o in others]
            tris.append(np.stack([e[0], e[2], e[1]], axis=1))

        # case: two in / two out -> quad (two triangles)
        for pair in itertools.combinations(range(4), 2):
            m = (n_in == 2) & inside[:, pair[0]] & inside[:, pair[1]]
            if not m.any():
                continue
            a, b = pair
            c, d = [o for o in range(4) if o not in pair]
            pac = edge_pt(m, a, c)
            pad = edge_pt(m, a, d)
            pbc = edge_pt(m, b, c)
            pbd = edge_pt(m, b, d)
            tris.append(np.stack([pac, pad, pbd], axis=1))
            tris.append(np.stack([pac, pbd, pbc], axis=1))

    tri_pts = np.concatenate(tris, axis=0)                   # [T, 3, 3]
    return _weld(tri_pts, spacing, origin)


def _weld(tri_pts: np.ndarray, spacing, origin):
    """Quantised vertex weld of a triangle soup -> indexed mesh."""
    flat = tri_pts.reshape(-1, 3)
    q = np.round(flat * 1024.0).astype(np.int64) + (1 << 20)
    # single packed int64 key (21 bits/axis): ~6x faster unique than a
    # structured-dtype view
    keys = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    _, first_idx, inv = np.unique(keys, return_index=True,
                                  return_inverse=True)
    verts = flat[first_idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces produced by welding
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    verts = verts * np.asarray(spacing, np.float32) + np.asarray(
        origin, np.float32)
    return verts.astype(np.float32), faces


def orient_faces_outward(verts, faces, sdf_fn, eps: float = 1e-3):
    """Flip faces whose normal points towards negative SDF."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    nn = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    c = (v0 + v1 + v2) / 3.0
    outward = np.asarray(sdf_fn(c + eps * nn)) > np.asarray(
        sdf_fn(c - eps * nn))
    faces = faces.copy()
    faces[~outward] = faces[~outward][:, ::-1]
    return faces


def face_areas(verts, faces) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)


def sample_surface(verts, faces, n: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted uniform surface samples [n, 3]."""
    rng = rng or np.random.default_rng()
    areas = face_areas(verts, faces)
    total = areas.sum()
    if total <= 0 or len(faces) == 0:
        return np.zeros((0, 3), np.float32)
    fi = rng.choice(len(faces), size=n, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=n)).astype(np.float32)
    r2 = rng.uniform(size=n).astype(np.float32)
    v0, v1, v2 = verts[faces[fi, 0]], verts[faces[fi, 1]], verts[faces[fi, 2]]
    return ((1 - r1)[:, None] * v0 + (r1 * (1 - r2))[:, None] * v1
            + (r1 * r2)[:, None] * v2)


def crop_mesh_near_pc(verts, faces, pc, crop_dist: float):
    """Keep faces with a vertex within crop_dist of the pointcloud
    (reference trainer.py:1527-1533)."""
    from scipy.spatial import cKDTree
    d, _ = cKDTree(pc).query(verts)
    keep_v = d < crop_dist
    keep_f = keep_v[faces].any(axis=1)
    faces = faces[keep_f]
    # re-index to referenced vertices only
    used = np.unique(faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces].astype(np.int32)


# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------

def write_ply(path: str, verts, faces, vert_colors=None):
    """Binary little-endian PLY (same container the reference exports,
    trainer.py:1544-1556)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as fh:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if vert_colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        fh.write(("\n".join(hdr) + "\n").encode())
        if vert_colors is None:
            fh.write(verts.tobytes())
        else:
            cols = np.asarray(vert_colors, np.uint8)
            rec = np.empty(len(verts),
                           dtype=[("v", np.float32, 3), ("c", np.uint8, 3)])
            rec["v"], rec["c"] = verts, cols
            fh.write(rec.tobytes())
        rec = np.empty(len(faces), dtype=[("n", np.uint8), ("i", np.int32, 3)])
        rec["n"] = 3
        rec["i"] = faces
        fh.write(rec.tobytes())


def read_ply(path: str):
    """Read ascii or binary-LE PLY with xyz vertices + triangle faces."""
    with open(path, "rb") as fh:
        data = fh.read()
    end = data.find(b"end_header\n")
    header = data[:end].decode().splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = [l for l in header if l.startswith("format")][0].split()[1]
    nv = int([l for l in header if l.startswith("element vertex")][0]
             .split()[-1])
    nf = int([l for l in header if l.startswith("element face")][0]
             .split()[-1])
    # vertex property layout
    vprops = []
    in_vertex = False
    for l in header:
        if l.startswith("element"):
            in_vertex = l.startswith("element vertex")
        elif l.startswith("property") and in_vertex:
            vprops.append(l.split()[1:])
    if fmt == "ascii":
        lines = body.decode().splitlines()
        verts = np.array([[float(x) for x in l.split()[:3]]
                          for l in lines[:nv]], np.float32)
        faces = np.array([[int(x) for x in l.split()[1:4]]
                          for l in lines[nv:nv + nf]], np.int32)
        return verts, faces
    sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1, "uint8": 1,
             "char": 1, "short": 2, "ushort": 2, "int": 4, "uint": 4,
             "int32": 4}
    vsize = sum(sizes[p[0]] for p in vprops)
    raw = np.frombuffer(body[:nv * vsize], dtype=np.uint8).reshape(nv, vsize)
    off = 0
    cols = {}
    for p in vprops:
        cols[p[1]] = (off, p[0])
        off += sizes[p[0]]
    def col(name):
        o, t = cols[name]
        dt = {"float": "<f4", "float32": "<f4", "double": "<f8"}[t]
        return raw[:, o:o + sizes[t]].copy().view(dt)[:, 0]
    verts = np.stack([col("x"), col("y"), col("z")], axis=1).astype(np.float32)
    fbody = body[nv * vsize:]
    faces = np.empty((nf, 3), np.int32)
    off = 0
    for i in range(nf):
        n = fbody[off]
        off += 1
        idx = struct.unpack_from(f"<{n}i", fbody, off)
        off += 4 * n
        faces[i] = idx[:3]
    return verts, faces


def read_obj(path: str):
    """Minimal OBJ reader: v / f lines (triangulates polygons)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load_mesh(path: str):
    if path.endswith(".obj"):
        return read_obj(path)
    if path.endswith(".ply"):
        return read_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")
