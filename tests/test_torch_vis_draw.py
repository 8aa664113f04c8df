"""The port's drawing pieces (vis/colormaps.py, vis/text.py, vis/raster.py,
vis/viewer.py, vis/composite.py, vis/display.py) against isdf_tpu's
matplotlib and cv2 drawing on the CPU.

* turbo: depth_to_rgb equals isdf_tpu's byte for byte.
* text: put_text equals cv2.putText pixel for pixel (cv2 5 antialiases
  FONT_HERSHEY_SIMPLEX whatever the line type, so LINE_8 and LINE_AA are
  both held exactly).
* geometry: every vertex's pixel coordinates equal matplotlib's within
  1e-6 px (float64); the draw order of faces, points, segments and whole
  artists equals matplotlib's as an index array.
* shades: the face colours equal isdf_tpu's exactly.
* images: each render against isdf_tpu's matplotlib image by the bounds
  below; a planted projection or order fault fails them.
* area resize and the tiled display against cv2 / isdf_tpu.
"""

import cv2
import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

from isdf_tpu.vis import composite as JC  # noqa: E402
from isdf_tpu.vis import display as JD  # noqa: E402
from isdf_tpu.vis import viewer as JV  # noqa: E402
from isdf_tpu.vis import views as JVW  # noqa: E402
from isdf_tpu_torch.utils import image_io as IO  # noqa: E402
from isdf_tpu_torch.vis import composite as TC  # noqa: E402
from isdf_tpu_torch.vis import display as TD  # noqa: E402
from isdf_tpu_torch.vis import raster as RS  # noqa: E402
from isdf_tpu_torch.vis import text as TX  # noqa: E402
from isdf_tpu_torch.vis import viewer as TV  # noqa: E402
from isdf_tpu_torch.vis import views as TVW  # noqa: E402

# Image bounds: the tighter of the ceiling (IoU >= 0.95; mean |diff| <= 12
# levels after a 5x5 box blur) and twice the largest gap measured on these
# inputs by ``python -m tests.test_torch_vis_draw`` (worst IoU 0.9941, so
# 1 - 2 x 0.0059; 0.9988 dilated for points; worst blurred mean 0.1943
# levels: PERF.md, section 6).
IOU_MIN = 0.988
BLUR_MAX = 0.39
IOU_POINTS_MIN = 0.9976   # both masks dilated 3x3 first

VIEWS = ((45.0, 25.0, 1.0, 256), (-120.0, 40.0, 1.5, 128),
         (200.0, -10.0, 0.8, 200))


def uv_sphere(nu=16, nv=12, seed=0):
    """A closed, bumpy, anisotropic sphere mesh of 320 faces."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, np.pi, nv)[1:-1]
    ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1 + 0.1 * rng.standard_normal(T.shape)
    v = np.stack([r * np.sin(T) * np.cos(P), r * np.sin(T) * np.sin(P) * 1.3,
                  r * np.cos(T) * 0.8], -1).reshape(-1, 3)
    v = np.concatenate([v, [[0, 0, 0.8], [0, 0, -0.8]]]).astype(np.float32)
    f, n = [], nv - 2
    for i in range(n - 1):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = (i + 1) * nu + j, (i + 1) * nu + (j + 1) % nu
            f += [[a, c, b], [b, c, d]]
    top, bot = n * nu, n * nu + 1
    for j in range(nu):
        f += [[top, j, (j + 1) % nu],
              [bot, (n - 1) * nu + (j + 1) % nu, (n - 1) * nu + j]]
    return v + np.array([0.3, -0.2, 1.0], np.float32), np.array(f)


def scene(seed=3):
    """Composite inputs: the mesh, six poses on an arc, a depth image's
    pointcloud with values, a camera."""
    rng = np.random.default_rng(seed)
    v, f = uv_sphere()
    T = np.tile(np.eye(4), (6, 1, 1))
    for i in range(6):
        a = i * 0.5
        T[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        T[i, :3, 3] = [2 * np.cos(a), 2 * np.sin(a), 0.5 + 0.1 * i]
    cam = dict(fx=40.0, fy=40.0, cx=31.5, cy=23.5, W=64, H=48)
    depth = rng.uniform(0.5, 2.0, (48, 64)).astype(np.float32)
    depth[:5] = 0
    pcp, pcv = JC.backproject_depth(depth, T[-1], 40, 40, 31.5, 23.5,
                                    stride=2)
    return dict(verts=v, faces=f, kf_poses=T[:-1], cur_pose=T[-1],
                traj=T[:, :3, 3], pc_pts=pcp, pc_vals=pcv, cam=cam)


def blur5(x):
    x = np.asarray(x, np.float64)
    p = np.pad(x, ((2, 2), (2, 2), (0, 0)), mode="edge")
    c = np.pad(np.cumsum(np.cumsum(p, 0), 1), ((1, 0), (1, 0), (0, 0)))
    return (c[5:, 5:] - c[:-5, 5:] - c[5:, :-5] + c[:-5, :-5]) / 25


def dilate3(m):
    p = np.pad(m, 1)
    out = np.zeros_like(m)
    for dy in range(3):
        for dx in range(3):
            out |= p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
    return out


def agreement(a, b, dilate=False):
    """(IoU of the non-white masks, mean |diff| after a 5x5 box blur)."""
    ma, mb = (a != 255).any(-1), (b != 255).any(-1)
    if dilate:
        ma, mb = dilate3(ma), dilate3(mb)
    iou = (ma & mb).sum() / max((ma | mb).sum(), 1)
    return iou, float(np.abs(blur5(a) - blur5(b)).mean())


# ---------------------------------------------------------------- turbo


@pytest.mark.parametrize("max_depth", [None, 2.5])
def test_depth_to_rgb_equals_isdf_tpus(max_depth):
    rng = np.random.default_rng(0)
    d = rng.uniform(0.0, 4.0, (37, 53)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = 0.0
    d[0, :3] = [d.max(), 2.5, 1e-4]
    np.testing.assert_array_equal(TVW.depth_to_rgb(d, max_depth),
                                  JVW.depth_to_rgb(d, max_depth))
    z = np.zeros((4, 5), np.float32)
    np.testing.assert_array_equal(TVW.depth_to_rgb(z), JVW.depth_to_rgb(z))


# ---------------------------------------------------------------- text

ALL_CHARS = "".join(chr(c) for c in range(32, 127))
DRAWN = ("12 steps/s  train:1.2s eval:0.3s vis:0.8s", "scene_0",
         "mesh", "points", "step 600  loss 0.0123", "__main__ [a-z]")


@pytest.mark.parametrize("scale", [0.4, 0.45])
@pytest.mark.parametrize("line", [cv2.LINE_8, cv2.LINE_AA])
def test_put_text_equals_cv2(scale, line):
    rng = np.random.default_rng(int(scale * 100) + line)
    cases = [(c, (5, 20)) for c in ALL_CHARS]
    cases += [(s, org) for s in DRAWN + (ALL_CHARS,)
              for org in ((4, 14), (7, 23), (-3, 9), (8, 18))]
    for text, org in cases:
        bg = rng.integers(0, 256, (30, 420, 3), dtype=np.uint8)
        col = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = cv2.putText(bg.copy(), text, org, cv2.FONT_HERSHEY_SIMPLEX,
                           scale, col, 1, line)
        got = TX.put_text(bg.copy(), text, org, scale, col)
        np.testing.assert_array_equal(got, want, err_msg=repr(text))
    with pytest.raises(ValueError):
        TX.put_text(bg, "x", (0, 9), 0.5, col)


# ---------------------------------------------------------------- geometry


def _mpl_composite(kw, azim, elev, zoom, size, face_ids=True):
    """isdf_tpu's render_composite figure, drawn, with each face coloured
    by its index: (fig, ax, artists by kind)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import (Line3DCollection,
                                            Poly3DCollection)
    v, f = kw["verts"], kw["faces"]
    fig = plt.figure(figsize=(size / 100, size / 100), dpi=100)
    ax = fig.add_subplot(projection="3d")
    n = len(f)
    ids = np.stack([np.arange(n) / n, np.zeros(n), np.zeros(n)], 1)
    pc = Poly3DCollection(v[f], facecolors=ids, linewidths=0)
    ax.add_collection3d(pc)
    sc = ax.scatter(*kw["pc_pts"].T, c=np.zeros((len(kw["pc_pts"]), 3)),
                    s=1.2, linewidths=0, depthshade=False)
    (ln,) = ax.plot(*kw["traj"].T, color=JC.TRAJ_COLOR, linewidth=1.4)
    segs = np.concatenate([JC.frustum_segments(T, **{
        k: kw["cam"][k] for k in ("fx", "fy", "cx", "cy", "W", "H")})
        for T in kw["kf_poses"]])
    lc = Line3DCollection(segs, colors=JC.KF_COLOR, linewidths=0.9)
    ax.add_collection3d(lc)
    view = TC.composite_view(azim=azim, elev=elev, zoom=zoom, size=size,
                             **kw)
    x, y, z = (view.lims[0:2], view.lims[2:4], view.lims[4:6])
    ax.set_xlim(*x)
    ax.set_ylim(*y)
    ax.set_zlim(*z)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    return fig, ax, dict(polys=pc, points=sc, line=ln, segments=lc), view


@pytest.mark.parametrize("azim,elev,zoom,size", VIEWS)
def test_projection_and_order_equal_matplotlibs(azim, elev, zoom, size):
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import proj3d
    kw = scene()
    kw.pop("cur_pose")
    fig, ax, arts, view = _mpl_composite(kw, azim, elev, zoom, size)
    try:
        np.testing.assert_allclose(view.proj(), ax.M, rtol=0, atol=1e-12)
        pts = np.concatenate([kw["verts"], kw["pc_pts"], kw["traj"]])
        tx, ty, _ = proj3d.proj_transform(*pts.T.astype(np.float64), ax.M)
        disp = ax.transData.transform(np.stack([tx, ty], 1))
        px, py, _ = view.project(view.proj(), pts)
        np.testing.assert_allclose(px, disp[:, 0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(py, size - disp[:, 1], rtol=0, atol=1e-6)

        order = view.draw_order()
        kinds = [a.kind for a in order]
        mpl = sorted(arts, key=lambda k: arts[k].get_zorder())
        assert kinds == mpl
        by_kind = {a.kind: a for a in order}
        n = len(kw["faces"])
        drawn = np.rint(np.asarray(arts["polys"]._facecolors2d)[:, 0] * n)
        np.testing.assert_array_equal(by_kind["polys"].order,
                                      drawn.astype(int))
        np.testing.assert_array_equal(by_kind["points"].order,
                                      arts["points"]._z_markers_idx)
        np.testing.assert_array_equal(by_kind["segments"].order,
                                      np.arange(len(arts["segments"]
                                                    .get_segments())))
    finally:
        plt.close(fig)


# ---------------------------------------------------------------- shades


def test_face_colours_equal_isdf_tpus(monkeypatch):
    from mpl_toolkits.mplot3d import art3d
    seen = []
    orig = art3d.Poly3DCollection

    class Spy(orig):
        def __init__(self, verts, *a, **kw):
            seen.append(np.asarray(kw["facecolors"]))
            super().__init__(verts, *a, **kw)

    monkeypatch.setattr(art3d, "Poly3DCollection", Spy)
    v, f = uv_sphere()
    JV.render_mesh_image(v, f, size=64)
    JC.render_composite(verts=v, faces=f, size=64)
    mine = [TV.mesh_view(v, f, size=64).artists[0].colors,
            TC.composite_view(verts=v, faces=f, size=64).artists[0].colors]
    assert len(seen) == 2
    for a, b in zip(mine, seen):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- images


def _renders(azim, elev, zoom, size):
    """(label, isdf_tpu's image, the port's image, dilate) per render."""
    kw = scene()
    v, f = kw["verts"], kw["faces"]
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(3000, 3)).astype(np.float32) * [1, 0.7, 0.5]
    cols = rng.random((3000, 3))
    return [
        ("mesh", JV.render_mesh_image(v, f, azim, elev, size),
         TV.render_mesh_image(v, f, azim, elev, size), False),
        ("points", JV.render_pointcloud_image(pts, cols, azim, elev, size),
         TV.render_pointcloud_image(pts, cols, azim, elev, size), True),
        ("composite",
         JC.render_composite(azim=azim, elev=elev, zoom=zoom, size=size,
                             **kw),
         TC.render_composite(azim=azim, elev=elev, zoom=zoom, size=size,
                             **kw), False)]


@pytest.mark.parametrize("azim,elev,zoom,size", VIEWS)
def test_renders_agree_with_matplotlib(azim, elev, zoom, size):
    for label, want, got, dil in _renders(azim, elev, zoom, size):
        assert got.shape == want.shape == (size, size, 3)
        iou, blur = agreement(want, got, dilate=dil)
        assert iou >= (IOU_POINTS_MIN if dil else IOU_MIN), (label, iou)
        assert blur <= BLUR_MAX, (label, blur)


class _AzimFlipped(RS.View3D):
    def proj(self):
        return RS.proj_matrix(self.lims, self.elev, -self.azim)


class _OrderReversed(RS.View3D):
    def _project_artist(self, a, M):
        key = super()._project_artist(a, M)
        a.order = a.order[::-1]
        return key


@pytest.mark.parametrize("fault", [_AzimFlipped, _OrderReversed])
def test_planted_faults_fail_the_bounds(fault, monkeypatch):
    azim, elev, zoom, size = VIEWS[0]
    monkeypatch.setattr(RS, "View3D", fault)
    failed = []
    for label, want, got, dil in _renders(azim, elev, zoom, size):
        iou, blur = agreement(want, got, dilate=dil)
        if iou < (IOU_POINTS_MIN if dil else IOU_MIN) or blur > BLUR_MAX:
            failed.append(label)
    # a flipped azimuth moves every render; a reversed depth order shows
    # wherever faces or points overlap
    want = (["mesh", "points", "composite"] if fault is _AzimFlipped
            else ["mesh", "composite"])
    assert set(want) <= set(failed), failed


def test_render_is_deterministic_and_raises_without_the_library(
        monkeypatch):
    v, f = uv_sphere()
    a = TV.render_mesh_image(v, f, size=96)
    np.testing.assert_array_equal(a, TV.render_mesh_image(v, f, size=96))
    monkeypatch.setattr(RS.native, "load", lambda name: None)
    with pytest.raises(RuntimeError, match="raster.cpp"):
        TV.render_mesh_image(v, f, size=96)


# ---------------------------------------------------------------- display


# cv2.resize(..., INTER_AREA) within 1 level for the integer types and
# 1e-4 for float32 (utils/image_io.py::resize_area): the display's tile
# shapes, then shapes where an axis grows (cv2 interpolates on both axes
# there, the shrinking one included)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("src,wh", [((320, 320), (320, 240)),
                                    ((240, 240), (200, 240)),
                                    ((256, 256), (256, 192)),
                                    ((480, 640), (320, 240)),
                                    ((170, 300), (320, 240)),
                                    ((100, 100), (130, 90)),
                                    ((100, 100), (150, 150)),
                                    ((100, 100), (150, 100)),
                                    ((100, 100), (100, 150)),
                                    ((60, 80), (100, 70)),
                                    ((170, 300), (300, 170))])
def test_area_resize_on_display_tiles(src, wh, dtype):
    rng = np.random.default_rng(sum(src))
    if dtype == np.float32:
        a = rng.random(src + (3,), dtype=np.float32)
    else:
        a = rng.integers(0, np.iinfo(dtype).max + 1, src + (3,),
                         dtype=dtype)
    out = IO.resize_area(a, wh)
    want = cv2.resize(a, wh, interpolation=cv2.INTER_AREA)
    assert out.dtype == want.dtype and out.shape == want.shape
    d = np.abs(out.astype(np.float64) - want)
    assert d.max() <= (1e-4 if dtype == np.float32 else 1)


def test_compose_tiles_and_display_scenes_equal_isdf_tpus(tmp_path):
    rng = np.random.default_rng(2)
    v, f = uv_sphere()
    pts = rng.normal(size=(800, 3)).astype(np.float32)
    imgs = {f"img_{i}": rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
            for i in range(3)}
    # image-only tiles: exact, labels and caption included
    a = TD.compose_tiles(imgs, height=60, width=80)
    np.testing.assert_array_equal(a, JD.compose_tiles(imgs, height=60,
                                                      width=80))
    frames = ({"one": im, "__clear__": None} for im in imgs.values())
    pa = TD.display_scenes(frames, 60, 80, caption="run 3",
                           out_dir=str(tmp_path / "t"))
    frames = ({"one": im, "__clear__": None} for im in imgs.values())
    pb = JD.display_scenes(frames, 60, 80, caption="run 3",
                           out_dir=str(tmp_path / "j"))
    assert [p.split("/")[-1] for p in pa] == [p.split("/")[-1] for p in pb]
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(IO.imread(x), cv2.imread(y))
    # rendered tiles: within the image bounds
    scenes = {"mesh": ("mesh", v, f), "points": ("points", pts, None),
              "img": lambda: imgs["img_0"]}
    a = TD.compose_tiles(scenes, height=120, width=160)
    b = JD.compose_tiles(scenes, height=120, width=160)
    assert a.shape == b.shape
    assert TD.get_tile_shape(3, 0.75) == JD.get_tile_shape(3, 0.75)
    iou, blur = agreement(a, b)
    assert iou >= IOU_MIN and blur <= BLUR_MAX, (iou, blur)
    with pytest.raises(TypeError):
        TD.compose_tiles({"x": 3})


if __name__ == "__main__":
    # the measured agreement behind the bounds above:
    # python -m tests.test_torch_vis_draw
    for azim, elev, zoom, size in VIEWS:
        for label, want, got, dil in _renders(azim, elev, zoom, size):
            iou, blur = agreement(want, got, dilate=dil)
            raw = float(np.abs(want.astype(int) - got).mean())
            print(f"{label} azim {azim} elev {elev} zoom {zoom} size {size}:"
                  f" IoU {iou:.4f}{' (dilated)' if dil else ''}, blurred "
                  f"mean |diff| {blur:.4f}, raw mean |diff| {raw:.4f}")
