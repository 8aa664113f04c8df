"""The port's 2-D plot kit (vis/plot.py, vis/plot_font.py, the tables of
vis/colormaps.py) against matplotlib 3.10's Agg backend on the CPU.

* font: string extents equal FT2Font's ``get_width_height`` /
  ``get_descent`` at every size of the table (exactly), and Text window
  extents equal ``Text.get_window_extent`` (within 1e-6 px; the bound the
  kit needs is 1 px) for every alignment, rotation and a two-line text.
* ticks: locations, labels and offset text equal ``get_xticks()``,
  ``get_xticklabels()`` and the offset text on both axes over many data
  ranges and axes sizes (hypothesis), exactly.
* layout: every axes box after ``tight_layout`` within 1 px of
  matplotlib's (read: within 1e-6), the canvas sizes equal, for each
  figure type the callers make; ``loc="best"`` picks the same box.
* images: each figure within the image bound below of matplotlib's PNG;
  the figure moved by two pixels fails it.
* colours: tab10, hot and viridis equal matplotlib's tables.

The bound: IoU of the non-white pixels at least ``IOU_MIN`` and mean
|diff| after a 5x5 box blur at most ``BLUR_MAX`` levels. ``python -m
tests.test_torch_plot`` reads every figure type (these builders, the three
plots of eval/figs.py and the three debug figures): worst IoU 0.9883
(faint fringes of text and strokes), worst blurred mean 0.1766 levels
(vis_embedding with a random-Fourier matrix), so the bound holds with a
margin of 0.008 in IoU and 2.5x in blurred levels; PERF.md section 6.
"""

import io
import os

import matplotlib
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

matplotlib.use("Agg")

import matplotlib.pyplot as mplt  # noqa: E402
from matplotlib import ft2font  # noqa: E402
from matplotlib.backends.backend_agg import get_hinting_flag  # noqa: E402

from isdf_tpu_torch.utils import image_io as IO  # noqa: E402
from isdf_tpu_torch.vis import colormaps as CM  # noqa: E402
from isdf_tpu_torch.vis import plot as P  # noqa: E402
from isdf_tpu_torch.vis import plot_font as PF  # noqa: E402
from isdf_tpu_torch.vis.slices import VIRIDIS  # noqa: E402

IOU_MIN = 0.98
BLUR_MAX = 0.45
FONT_DIR = os.path.join(matplotlib.get_data_path(), "fonts", "ttf")
FACES = {"normal": "DejaVuSans.ttf", "italic": "DejaVuSans-Oblique.ttf"}
SIZES = ([("normal", pt, dpi) for pt in (7, 8, 9, 10, 12)
          for dpi in (100, 110, 120)]
         + [("italic", 12, dpi) for dpi in (100, 110, 120)])


def blur5(x):
    x = np.asarray(x, np.float64)
    p = np.pad(x, ((2, 2), (2, 2), (0, 0)), mode="edge")
    c = np.pad(np.cumsum(np.cumsum(p, 0), 1), ((1, 0), (1, 0), (0, 0)))
    return (c[5:, 5:] - c[:-5, 5:] - c[5:, :-5] + c[:-5, :-5]) / 25


def agreement(a, b):
    """(IoU of the non-white masks, mean |diff| after a 5x5 box blur)."""
    ma, mb = (a != 255).any(-1), (b != 255).any(-1)
    iou = (ma & mb).sum() / max((ma | mb).sum(), 1)
    return iou, float(np.abs(blur5(a) - blur5(b)).mean())


def mpl_png(fig, dpi, bbox_inches=None):
    """matplotlib's PNG of a figure, decoded by the port: RGB uint8."""
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=dpi, bbox_inches=bbox_inches)
    mplt.close(fig)
    return IO.imdecode(buf.getvalue())[..., ::-1]


def read_rgb(path):
    return IO.imread(str(path))[..., ::-1]


def assert_within_bound(want, got, label=""):
    assert want.shape == got.shape, (label, want.shape, got.shape)
    iou, blur = agreement(want, got)
    assert iou >= IOU_MIN and blur <= BLUR_MAX, (label, iou, blur)
    return iou, blur


class Captured:
    """The Figure objects both packages save, in order (for their boxes
    after tight_layout)."""

    def __init__(self, monkeypatch):
        import matplotlib.figure as MF
        self.mpl, self.kit = [], []
        m_save, k_save = MF.Figure.savefig, P.Figure.savefig

        def m(fig, *a, **k):
            self.mpl.append(fig)
            return m_save(fig, *a, **k)

        def t(fig, *a, **k):
            self.kit.append(fig)
            return k_save(fig, *a, **k)
        monkeypatch.setattr(MF.Figure, "savefig", m)
        monkeypatch.setattr(P.Figure, "savefig", t)
        monkeypatch.setattr(mplt, "close", lambda *a, **k: None)


def assert_same_boxes(mfig, kfig, tol=1.0):
    """Every visible axes box in pixels at the layout dpi, and the
    subplot parameters behind them."""
    maxes = [a for a in mfig.axes if a.get_visible()]
    kaxes = [a for a in kfig.axes if a.visible]
    assert len(maxes) == len(kaxes)
    W, H = mfig.get_size_inches() * mfig.dpi
    for ma, ka in zip(maxes, kaxes):
        want = np.asarray(ma.get_position().extents) * (W, H, W, H)
        got = np.asarray(ka.position()) * (W, H, W, H)
        assert np.abs(want - got).max() <= tol, (want, got)


def _rays_full(rng, regions, scale):
    return {r: {"av_l1": float(rng.random()) * scale,
                "binned_l1": (rng.random(6) * scale).tolist(),
                "l1_chomp_costs": rng.random(3).tolist(),
                "av_cossim": rng.random(3).tolist()} for r in regions}


def write_runs(root):
    """<root>/<seq>_<i>/vox_res.json for three repeats of three of the
    paper's sequences (the reference's exp0 layout), one repeat unfinished;
    and <root>/single, one run in the vox_res.json schema with every
    region (visible surface, volume, objects)."""
    import json
    root = str(root)
    rng = np.random.default_rng(11)
    times = (0.5, 1.0, 2.0, 3.5, 5.0)
    for seq in ("apt_2_nav", "apt_3_obj", "scene0010_00"):
        for i in range(3):
            d = os.path.join(root, f"{seq}_{i}")
            os.makedirs(d)
            last = 3.5 if (seq, i) == ("apt_3_obj", 2) else 5.0
            with open(os.path.join(d, "vox_res.json"), "w") as f:
                json.dump({f"{t:.3f}": {"time": t, "rays": _rays_full(
                    rng, ("vis", "vox"), 0.3 / (1 + t))}
                    for t in times if t <= last}, f)
    entries = {}
    for k in range(12):
        t = 0.4 + 0.9 * k + 0.1 * rng.random()
        entries[f"{t:.3f}"] = {
            "time": t, "rays": _rays_full(rng, ("vis", "vox"), 0.5 / (1 + t)),
            "visible_surf": {"vis": {"av_l1": float(rng.random()) * 0.1}},
            "vol": {"av_l1": float(rng.random()) * 0.2},
            "objects": {"l1": rng.random(3).tolist() + [None]}}
    os.makedirs(os.path.join(root, "single"))
    with open(os.path.join(root, "single", "vox_res.json"), "w") as f:
        json.dump(entries, f)


# ------------------------------------------------------------------ font
@pytest.mark.parametrize("face,pt,dpi", SIZES)
def test_string_extents_equal_freetypes(face, pt, dpi):
    font = ft2font.FT2Font(os.path.join(FONT_DIR, FACES[face]), 8,
                           _kerning_factor=0)
    font.set_size(pt, dpi)
    rng = np.random.default_rng(pt * 1000 + dpi)
    chars = list(PF.CHARS)
    words = ["simulated time [s]", "SDF error [cm]", "\N{MINUS SIGN}0.25",
             "AVAT To Wa", "lp", " ", "j", "1e\N{MINUS SIGN}5+6e-1"]
    words += ["".join(rng.choice(chars, rng.integers(1, 16)))
              for _ in range(150)]
    for s in words:
        font.set_text(s, 0, flags=get_hinting_flag())
        w, h = font.get_width_height()
        want = (w / 64, h / 64, font.get_descent() / 64)
        assert PF.text_extent(s, pt, dpi, face) == want, s


TEXTS = [("simulated time [s]", "center", "top", 0, 10),
         ("SDF error [cm]", "center", "bottom", 90, 8),
         ("Signed distance [m]", "left", "center", 90, 10),
         ("0.25", "right", "center_baseline", 0, 10),
         ("\N{MINUS SIGN}1.0", "left", "center_baseline", 0, 10),
         ("apt_2_nav", "center", "baseline", 0, 12),
         ("no surface region\n(online res.json)", "center", "baseline", 0, 9),
         ("vis region", "center", "top", 0, 12),
         ("1e\N{MINUS SIGN}12+6e\N{MINUS SIGN}1", "left", "baseline", 0, 10)]


@pytest.mark.parametrize("s,ha,va,rot,size", TEXTS)
@pytest.mark.parametrize("dpi", [100, 120])
def test_text_extents_equal_matplotlibs(s, ha, va, rot, size, dpi):
    fig = mplt.figure(figsize=(4, 3), dpi=dpi)
    r = fig.canvas.get_renderer()
    rm = "anchor" if va == "bottom" else "default"
    t = fig.text(0.37, 0.41, s, ha=ha, va=va, rotation=rot, fontsize=size,
                 rotation_mode=rm)
    want = t.get_window_extent(r).extents
    kfig = P.Figure((4, 3), dpi)
    mine = P.Text(lambda f: f.frac_to_display(0.37, 0.41), s, size, ha=ha,
                  va=va, rotation=rot, rotation_mode=rm)
    got = mine.window_extent(kfig)
    mplt.close(fig)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_text_outside_the_table_raises():
    with pytest.raises(ValueError, match="table"):
        PF.text_extent("x", 11, 100)
    with pytest.raises(ValueError, match="not in the plot font"):
        PF.text_extent("\N{DEGREE SIGN}", 10, 100)


# ------------------------------------------------------------------ ticks
def _tick_pair(x0, xspan, y0, yspan, w, h):
    x = np.array([x0, x0 + xspan])
    y = np.array([y0, y0 + yspan])
    fig, ax = mplt.subplots(figsize=(w, h))
    ax.plot(x, y)
    fig.canvas.draw()
    kfig, kax = P.subplots(figsize=(w, h))
    kax.plot(x, y)
    return fig, ax, kax


def _assert_same_ticks(ax, kax):
    for a, axis in (("x", ax.xaxis), ("y", ax.yaxis)):
        locs, labels, off, _ = kax.ticks(a)
        np.testing.assert_array_equal(locs, axis.get_majorticklocs())
        assert labels == [t.get_text() for t in axis.get_majorticklabels()]
        assert off == axis.get_offset_text().get_text()
        assert tuple(kax.view(a)) == tuple(
            ax.get_xlim() if a == "x" else ax.get_ylim())


@settings(max_examples=120, deadline=None, database=None, derandomize=True)
@given(x0=st.floats(-1e7, 1e7), xe=st.floats(-7, 7),
       y0=st.floats(-1e3, 1e3), ye=st.floats(-6, 3),
       w=st.sampled_from([2.0, 3.3, 4.3, 6.4, 11.0]),
       h=st.sampled_from([1.5, 2.1, 3.2, 4.8]))
def test_ticks_equal_matplotlibs(x0, xe, y0, ye, w, h):
    fig, ax, kax = _tick_pair(x0, 10.0 ** xe, y0, 10.0 ** ye, w, h)
    try:
        _assert_same_ticks(ax, kax)
    finally:
        mplt.close(fig)


@pytest.mark.parametrize("x,y", [
    ([0.6, 1.2, 1.8, 2.4], [0.6 + 1e-14, 0.6, 0.6 - 2e-14, 0.6]),  # offset
    ([0.0, 1e-6], [3e-7, 1e-5]),                  # order of magnitude
    ([1e6, 1e6 + 3], [2.0, 2.0]),                 # singular y
    ([-2.5, -2.4], [-1e4, 5e4]),
    ([5.0], [7.0]),                               # one point
])
def test_tick_edge_cases_equal_matplotlibs(x, y):
    fig, ax = mplt.subplots(figsize=(4, 3))
    ax.plot(x, y, ".-")
    fig.canvas.draw()
    kfig, kax = P.subplots(figsize=(4, 3))
    kax.plot(x, y, ".-")
    _assert_same_ticks(ax, kax)
    mplt.close(fig)


# ------------------------------------------------------------------ layout
def _grid(plt, rng_seed=0, legend_ncol=1):
    """A fig-8-like grid: bands, titles, y labels, legends, a hidden axes,
    a suptitle."""
    rng = np.random.default_rng(rng_seed)
    fig, ax = plt.subplots(nrows=3, ncols=2, figsize=(8.6, 9.6),
                           squeeze=False)
    t = np.linspace(0.5, 5.0, 5)
    for r in range(3):
        for c in range(2):
            a = ax[r][c]
            if (r, c) == (2, 1):
                a.set_visible(False)
                continue
            m = rng.random(5) * 10 ** (r - 1)
            s = rng.random(5) * 0.1 * 10 ** (r - 1)
            a.plot(t, m, color="C0", label="iSDF (n=3)" if r == 0 else None)
            a.fill_between(t, m - s, m + s, alpha=0.4, color="C0")
            a.set_ylabel(["SDF error [cm]", "Collision cost error",
                          "Gradient cosine distance"][r], fontsize=8)
            if r == 0:
                a.set_title(f"apt_{c}_nav", style="italic")
                a.legend(fontsize=8, ncol=legend_ncol)
            a.set_xlabel("Sequence time [s]")
    fig.suptitle("vis region", y=1.0)
    fig.tight_layout()
    return fig


def _dashboard(plt):
    """A per_seq-like dashboard: a gridspec with a spanning strip, dashed
    and dotted lines, markers, fixed tick labels, an annotation, vlines and
    limits."""
    rng = np.random.default_rng(1)
    fig = plt.figure(figsize=(16, 9))
    gs = fig.add_gridspec(3, 4, height_ratios=[1, 1, 0.6])
    axes = [fig.add_subplot(gs[r, c]) for r in range(2) for c in range(4)]
    strip = fig.add_subplot(gs[2, :])
    t = np.linspace(0.4, 9.0, 12)
    for i, ax in enumerate(axes[:4]):
        for k, style in enumerate(("-", "--", ":", ".-")[:i + 1]):
            ax.plot(t, rng.random(12) * 0.3, style, label=f"eps={k}")
        ax.legend(fontsize=7)
        ax.set_title("binned L1 by GT distance [m]")
        ax.set_xlabel("simulated time [s]", fontsize=8)
    axes[4].annotate("no cossim in artifact\n(online res.json)",
                     (0.5, 0.5), xycoords="axes fraction", ha="center",
                     fontsize=9, color="gray")
    axes[5].plot(range(6), rng.random(6), ":", label="t=1s")
    axes[5].set_xticks(range(6), ["<0", "0-0.1", "0.1-0.2", "0.2-0.5",
                                  "0.5-1", ">1"], fontsize=7)
    axes[5].legend(fontsize=7)
    strip.vlines(t, 0, 1, color="C3", lw=1)
    strip.set_xlim(0, 9.5)
    strip.set_yticks([])
    strip.set_title("keyframe timeline (12 keyframes)")
    fig.tight_layout()
    return fig


def _cbar(plt):
    x = np.linspace(0, 5, 640)
    emb = np.sin(x[:, None] * 2.0 ** np.arange(6)[None, :])
    fig, ax = plt.subplots(figsize=(8, 3.2))
    im = ax.imshow(emb.T, cmap="hot", interpolation="nearest",
                   aspect="auto", origin="lower", extent=[0, 5, 0, 6])
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("x values")
    ax.set_ylabel("embeddings")
    fig.tight_layout()
    return fig


def _tight_rows(plt):
    rng = np.random.default_rng(2)
    fig, axes = plt.subplots(2, 1, figsize=(11, 6.6), squeeze=False)
    for j in range(2):
        ax = axes[j, 0]
        x = np.sort(rng.random(27) * 4)
        ax.hlines(0, x[0], x[-1], color="gray", linestyle="--", lw=1)
        ax.plot(x, 2 - x, label="Ray", color="C3", lw=2.5)
        ax.plot(x, 1.9 - x, label="Predicted", color="k", linestyle=":",
                lw=2)
        if j == 0:
            ax.legend(fontsize=9, ncol=2)
    fig.text(0.04, 0.5, "Signed distance [m]", va="center",
             rotation="vertical")
    return fig


def _thumbs(plt):
    """Downsampled images over a strip (the keyframe thumbnails), one of
    them constant (Normalize maps it to 0)."""
    fig = plt.figure(figsize=(8, 2))
    gs = fig.add_gridspec(1, 1)
    ax = fig.add_subplot(gs[0, :])
    ax.vlines([0.5, 2.0, 3.5], 0, 1, color="C3", lw=1)
    ax.set_xlim(0, 5)
    ax.set_yticks([])
    yy, xx = np.mgrid[0:48, 0:64]
    for k, x0 in enumerate((0.5, 2.0, 3.5)):
        dep = np.ones((48, 64)) if k == 1 else np.sin(xx / 7.0 + k) + yy / 48
        ax.imshow(dep / dep.max(), extent=(x0, x0 + 0.8, 0.15, 0.95),
                  aspect="auto", cmap="viridis", zorder=2)
    ax.set_ylim(0, 1)
    fig.tight_layout()
    return fig


FIGURES = [("grid", _grid, 110, None), ("dashboard", _dashboard, 120, None),
           ("thumbnails", _thumbs, 120, None),
           ("colorbar", _cbar, 110, None),
           ("tight_rows", _tight_rows, 110, "tight")]


@pytest.mark.parametrize("name,build,dpi,bbox", FIGURES,
                         ids=[f[0] for f in FIGURES])
def test_layout_and_image_equal_matplotlibs(name, build, dpi, bbox):
    mfig, kfig = build(mplt), build(P)
    want = mpl_png(mfig, dpi, bbox)         # draws: active positions set
    assert_same_boxes(mfig, kfig, tol=1e-6)
    got = kfig.render(dpi, bbox)[..., :3]
    assert want.shape == got.shape                     # the canvas
    assert_within_bound(want, got, name)
    # the bound has teeth: the same figure two pixels off fails it
    moved = np.full_like(got, 255)
    moved[:, 2:] = got[:, :-2]
    iou, blur = agreement(want, moved)
    assert iou < IOU_MIN or blur > BLUR_MAX, (name, iou, blur)


@pytest.mark.parametrize("seed", range(12))
def test_best_legend_location_equals_matplotlibs(seed):
    rng = np.random.default_rng(100 + seed)

    def build(plt):
        fig, ax = plt.subplots(figsize=(5, 3.5))
        for k in range(1 + seed % 3):
            x = np.linspace(0, 1, 20 + 10 * k)
            y = rng_y[k]
            ax.plot(x, y, label=f"line {k}" * (1 + k % 2))
        if seed % 4 == 1:
            ax.annotate("a note\nin two lines", (0.8, 0.85),
                        xycoords="axes fraction", ha="center", fontsize=9)
        leg = ax.legend(fontsize=[7, 8, 9, 10][seed % 4], ncol=1 + seed % 2)
        return fig, ax, leg

    rng_y = [np.cumsum(rng.normal(size=20 + 10 * k)) for k in range(3)]
    mfig, max_, mleg = build(mplt)
    mfig.canvas.draw()
    kfig, kax, kleg = build(P)
    want = mleg.get_window_extent().extents
    got = kleg.window_extent(kfig)
    mplt.close(mfig)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ------------------------------------------------------------------ colours
def test_colour_tables_equal_matplotlibs():
    x = np.linspace(-0.2, 1.2, 2001)
    for name, table in (("hot", CM.HOT), ("viridis", VIRIDIS)):
        np.testing.assert_array_equal(
            CM.lookup(table, x), matplotlib.colormaps[name](x)[:, :3])
    cycle = matplotlib.rcParams["axes.prop_cycle"].by_key()["color"]
    assert list(CM.TAB10) == cycle
    for i in range(10):
        np.testing.assert_array_equal(
            P.to_rgb(f"C{i}"), matplotlib.colors.to_rgb(f"C{i}"))
    for c in ("gray", "k", "0.8", "#17becf"):
        np.testing.assert_allclose(P.to_rgb(c), matplotlib.colors.to_rgb(c))


def test_kit_scope_raises_outside_it():
    fig, ax = P.subplots()
    with pytest.raises(ValueError, match="aspect"):
        ax.imshow(np.zeros((2, 2)), aspect="equal")
    with pytest.raises(ValueError, match="axes fraction"):
        ax.annotate("x", (0, 0), xycoords="data")


def readings():
    """Each figure type against matplotlib's: (name, IoU, blurred mean)."""
    import tempfile

    import jax

    from isdf_tpu.eval import debug as JD
    from isdf_tpu.eval import figs as JF
    from isdf_tpu.ops.embedding import init_gaussian_embedding
    from isdf_tpu_torch.eval import debug as TD
    from isdf_tpu_torch.eval import figs as TF

    out = []
    for name, build, dpi, bbox in FIGURES:
        want = mpl_png(build(mplt), dpi, bbox)
        out.append((name, *agreement(want, build(P).render(dpi, bbox)[
            ..., :3])))
    with tempfile.TemporaryDirectory() as d:
        write_runs(d)
        rows = [["apt_2_nav", "apt_3_obj"], ["scene0010_00", "x"]]
        B = np.array(init_gaussian_embedding(jax.random.PRNGKey(0),
                                             n_feats=16))
        rng = np.random.default_rng(0)
        rays = []
        for j in range(3):
            z = np.sort(rng.random(27) * 4 + 0.1)
            rays.append({k: (2.0 + 0.3 * j - z) * f for k, f in (
                ("gt", 0.7), ("ray", 1.0), ("normal", 0.8), ("pc", 0.6),
                ("pred", 0.72))})
            rays[-1]["z"] = z
        cases = [
            ("plot_fig8", lambda m, p: m.plot_fig8(d, p, seq_rows=rows)),
            ("plot_all_seq", lambda m, p: m.plot_all_seq(d, p)),
            ("plot_per_seq", lambda m, p: m.plot_per_seq(
                os.path.join(d, "single"), p)),
            ("vis_embedding", lambda m, p: m.vis_embedding(p, scale=0.5)),
            ("vis_embedding B", lambda m, p: m.vis_embedding(p, B=B)),
            ("ray_oracle_figure", lambda m, p: m.ray_oracle_figure(
                None, p, rays=rays))]
        for name, fn in cases:
            jm, tm = ((JF, TF) if name.startswith("plot") else (JD, TD))
            fn(jm, os.path.join(d, "j.png"))
            fn(tm, os.path.join(d, "t.png"))
            out.append((name, *agreement(read_rgb(os.path.join(d, "j.png")),
                                         read_rgb(os.path.join(d, "t.png")))))
        # check_gt_sdf's panel on paired trainers and isdf_tpu's draws
        from isdf_tpu.vis import debug as JVD
        from isdf_tpu_torch.vis import debug as TVD
        from tests.test_torch_debug import jax_check_draws, make_pair
        tt, jt = make_pair()
        JVD.check_gt_sdf(jt, seed=2, out_file=os.path.join(d, "j.png"))
        TVD.check_gt_sdf(tt, seed=2, out_file=os.path.join(d, "t.png"),
                         draws=jax_check_draws(tt, 2))
        out.append(("check_gt_sdf", *agreement(
            read_rgb(os.path.join(d, "j.png")),
            read_rgb(os.path.join(d, "t.png")))))
    return out


if __name__ == "__main__":
    for name, iou, blur in readings():
        print(f"{name}: IoU {iou:.4f}, blurred mean |diff| {blur:.4f} "
              "levels")
