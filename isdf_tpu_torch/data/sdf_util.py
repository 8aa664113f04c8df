"""GT SDF grid tooling (isdf_tpu/data/sdf_util.py; reference
isdf/datasets/sdf_util.py).

Grid IO in the reference's formats, the scipy interpolator with the same
out-of-bounds modes (host), its torch counterpart on a device
(``trilinear_interp``), the SDF colormap (matplotlib's RdBu through a
TwoSlopeNorm, rebuilt in numpy: the card machine has no matplotlib), and
mesh -> SDF generation (voxel occupancy + EDT) on the port's mesh layer
(utils/mesh3d).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage
from scipy.interpolate import RegularGridInterpolator


# ---------------------------------------------------------------------------
# grid IO (reference sdf_util.py:21-96)
# ---------------------------------------------------------------------------

def read_sdf_npy(path: str) -> np.ndarray:
    return np.load(path)


def read_sdf_binary(path: str, dims) -> np.ndarray:
    """Flat float32 binary dump ordered x-major (gpufusion style)."""
    grid = np.fromfile(path, dtype=np.float32)
    return grid.reshape(dims)


def read_sdf_habitat_txt(path: str) -> np.ndarray:
    """habitat-sim text dump: first line dims, then flat values."""
    with open(path) as f:
        dims = [int(x) for x in f.readline().split()]
        vals = np.loadtxt(f, dtype=np.float32)
    return vals.reshape(dims)


def read_sdf_gpufusion(sdf_file: str, transform_file: str):
    """GPU-fusion (KinectFusion+) SDF: text grid + header transform of
    'dims', 'voxel size', 'offset' lines (reference sdf_util.py:70-85)."""
    with open(transform_file) as f:
        dims = [int(e) for e in f.readline().split()[1:]]
        vsm = [float(e) for e in f.readline().split()[1:]]
        offset = [float(e) for e in f.readline().split()[1:]]
    transform = np.eye(4)
    transform[:3, 3] = offset
    transform[np.diag_indices_from(transform[:3, :3])] = vsm
    sdf = np.loadtxt(sdf_file).reshape(dims)
    return sdf, transform


def load_transform_txt(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32).reshape(4, 4)


def merge_sdfs(grids) -> np.ndarray:
    """Compose a scene SDF as the min over component SDFs (reference
    sdf_util.py:98-148 / replicaCAD_gt_sdf.py:81-144)."""
    out = grids[0]
    for g in grids[1:]:
        out = np.minimum(out, g)
    return out


# ---------------------------------------------------------------------------
# interpolation (reference sdf_util.py:174-273)
# ---------------------------------------------------------------------------

def sdf_interpolator(sdf_grid: np.ndarray, transform: np.ndarray):
    """scipy RegularGridInterpolator in world coordinates.

    transform: voxel index -> world (axis-aligned scale + offset), the
    reference's 1cm/transform.txt convention (trainer.py:446-453)."""
    dims = sdf_grid.shape
    axes = [transform[i, i] * np.arange(dims[i]) + transform[i, 3]
            for i in range(3)]
    return RegularGridInterpolator(axes, sdf_grid, bounds_error=True)


def eval_sdf_interp(interp, pts, handle_oob: str = "except",
                    oob_val: float = 0.0):
    """The reference's out-of-bounds modes (sdf_util.py:174-216): except |
    mask (returns (vals, valid)) | fill (vals with oob_val outside)."""
    pts = np.asarray(pts).reshape(-1, 3)
    lo = np.array([g[0] for g in interp.grid])
    hi = np.array([g[-1] for g in interp.grid])
    inside = np.all((pts >= lo) & (pts <= hi), axis=-1)
    if handle_oob == "except":
        return interp(pts)
    safe = np.clip(pts, lo, hi)
    vals = interp(safe)
    if handle_oob == "mask":
        return vals, inside
    if handle_oob == "fill":
        return np.where(inside, vals, oob_val)
    raise ValueError(handle_oob)


def trilinear_interp(grid, transform, device=None):
    """Device-resident trilinear SDF interpolator: pts [N, 3] -> [N]
    (isdf_tpu's trilinear_interp_jax): the grid lives on ``device`` (the
    points' device if None), queries never leave it. Clamps to the grid
    boundary as isdf_tpu does."""
    grid = torch.as_tensor(np.asarray(grid, np.float32), device=device)
    inv_scale = torch.tensor([1.0 / float(transform[i, i]) for i in range(3)],
                             device=grid.device)
    offset = torch.tensor([float(transform[i, 3]) for i in range(3)],
                          device=grid.device)
    dims = torch.tensor(grid.shape, device=grid.device)
    flat = grid.reshape(-1)
    stride = (grid.shape[1] * grid.shape[2], grid.shape[2], 1)

    def interp(pts):
        pts = torch.as_tensor(pts, dtype=torch.float32, device=grid.device)
        idx = (pts - offset) * inv_scale
        idx = torch.minimum(idx.clamp(min=0.0),
                            dims.to(torch.float32) - 1.0 - 1e-6)
        i0 = idx.floor().to(torch.long)
        frac = idx - i0
        i1 = torch.minimum(i0 + 1, dims - 1)
        c = 0.0
        for dx, wx in ((i0[:, 0], 1 - frac[:, 0]), (i1[:, 0], frac[:, 0])):
            for dy, wy in ((i0[:, 1], 1 - frac[:, 1]),
                           (i1[:, 1], frac[:, 1])):
                for dz, wz in ((i0[:, 2], 1 - frac[:, 2]),
                               (i1[:, 2], frac[:, 2])):
                    v = flat[dx * stride[0] + dy * stride[1] + dz]
                    c = c + wx * wy * wz * v
        return c

    return interp


# ---------------------------------------------------------------------------
# colormap (reference sdf_util.py:276-306)
# ---------------------------------------------------------------------------

# matplotlib's "RdBu" (ColorBrewer), 11 colours evenly spaced on [0, 1]
_RDBU = np.array([(103, 0, 31), (178, 24, 43), (214, 96, 77),
                  (244, 165, 130), (253, 219, 199), (247, 247, 247),
                  (209, 229, 240), (146, 197, 222), (67, 147, 195),
                  (33, 102, 172), (5, 48, 97)]) / 255.0
_LUT_N = 256


def _rdbu_lut() -> np.ndarray:
    """[N, 4] lookup table of LinearSegmentedColormap.from_list("RdBu",
    colours, 256): each channel interpolated linearly at linspace(0, 1,
    N), as matplotlib's _create_lookup_table builds it."""
    x = np.linspace(0.0, 1.0, len(_RDBU)) * (_LUT_N - 1)
    xind = (_LUT_N - 1) * np.linspace(0, 1, _LUT_N) ** 1.0
    lut = np.ones((_LUT_N, 4))
    for ch in range(3):
        y = _RDBU[:, ch]
        ind = np.searchsorted(x, xind)[1:-1]
        dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut[:, ch] = np.clip(np.concatenate(
            [[y[0]], dist * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]]),
            0.0, 1.0)
    return lut


def get_colormap(sdf_range=(-2.0, 2.0), surface_cutoff: float = 0.01):
    """Callable sdf -> RGBA float [0, 1]: a diverging map with a green
    surface band, the reference's matplotlib colormap object in numpy
    (RdBu through TwoSlopeNorm(vmin, 0, vmax); NaN maps to transparent
    black, values beyond the range to the end colours)."""
    lut = _rdbu_lut()
    vmin, vmax = float(sdf_range[0]), float(sdf_range[1])

    class _CM:
        def to_rgba(self, vals, alpha=1.0, bytes=False):
            v = np.asarray(vals)
            xa = np.asarray(np.interp(v, [vmin, 0.0, vmax], [0.0, 0.5, 1.0],
                                      left=-np.inf, right=np.inf)) * _LUT_N
            xa[xa == _LUT_N] = _LUT_N - 1
            under, over, bad = xa < 0, xa >= _LUT_N, np.isnan(xa)
            with np.errstate(invalid="ignore"):
                ix = xa.astype(int)
            ix[under], ix[over] = 0, _LUT_N - 1
            rgba = lut[np.clip(ix, 0, _LUT_N - 1)]
            rgba[bad] = 0.0
            band = np.abs(v) < surface_cutoff
            rgba[band] = np.array([0.0, 1.0, 0.0, 1.0])
            rgba[..., 3] = alpha
            if bytes:
                rgba = (rgba * 255).astype(np.uint8)
            return rgba

    return _CM()


# ---------------------------------------------------------------------------
# mesh -> SDF (reference sdf_util.py:312-457)
# ---------------------------------------------------------------------------

def mesh_to_occupancy(verts, faces, dims, transform,
                      samples_per_area: float = 2000.0) -> np.ndarray:
    """Voxel occupancy by dense surface sampling (stand-in for the
    reference's trimesh voxelise-subdivide, sdf_util.py:312-368)."""
    from isdf_tpu_torch.utils import mesh3d

    rng = np.random.default_rng(0)
    area = mesh3d.face_areas(verts, faces).sum()
    n = int(min(max(area * samples_per_area, 10000), 4_000_000))
    pts = mesh3d.sample_surface(verts, faces, n, rng)
    idx = (pts - transform[:3, 3]) / np.diag(transform)[:3]
    idx = np.round(idx).astype(int)
    ok = np.all((idx >= 0) & (idx < np.asarray(dims)), axis=-1)
    occ = np.zeros(dims, bool)
    occ[tuple(idx[ok].T)] = True
    return occ


def occupancy_to_sdf(occ: np.ndarray, voxel_size: float,
                     inside_mask=None) -> np.ndarray:
    """Unsigned distance by an EDT, signed by an inside mask (reference
    sdf_util.py:371-385)."""
    outside_d = ndimage.distance_transform_edt(~occ) * voxel_size
    if inside_mask is None:
        return outside_d
    return np.where(inside_mask, -outside_d, outside_d)


def mesh_to_sdf(verts, faces, dims, transform) -> np.ndarray:
    """Dense SDF of a closed mesh on the given grid; the sign from a flood
    fill from the grid boundary (outside = reachable)."""
    occ = mesh_to_occupancy(verts, faces, dims, transform)
    free = ~occ
    labels, _ = ndimage.label(free)
    border_labels = np.unique(np.concatenate([
        labels[0].ravel(), labels[-1].ravel(),
        labels[:, 0].ravel(), labels[:, -1].ravel(),
        labels[:, :, 0].ravel(), labels[:, :, -1].ravel()]))
    outside = np.isin(labels, border_labels[border_labels != 0])
    inside = free & ~outside
    voxel = float(transform[0, 0])
    return occupancy_to_sdf(occ, voxel, inside_mask=inside)
