"""A 2-D plot kit: what matplotlib 3.10's Agg backend draws for the calls
the port's figures make (eval/figs.py, eval/debug.py, vis/debug.py), from
numpy and host C++ only (the card machine has no matplotlib).

Scope: ``figure`` / ``subplots``, ``add_gridspec`` with
height ratios and ``add_subplot`` of a cell or a slice; on an Axes
``plot`` (fmt '-', '--', ':', '.-'), ``fill_between``, ``hlines`` /
``vlines``, ``imshow`` (extent, aspect "auto", origin, interpolation,
cmap, zorder), ``legend`` (fontsize, ncol, loc "best"), ``annotate`` in
axes fraction, titles, labels, fixed ticks, limits and ``set_visible``;
on the Figure ``colorbar``, ``suptitle``, ``text``, ``tight_layout`` and
``savefig`` (dpi, ``bbox_inches="tight"``). Anything else raises.

What is matplotlib's, as code and constants (matplotlib 3.10 is under the
PSF-style Matplotlib licence; the algorithms below follow its sources):
the rcParams defaults (lines 1.5 pt with projecting caps and round joins,
dashes scaled by the line width; spines 0.8 pt; ticks out, 3.5 pt long,
0.8 pt wide, labels 3.5 pt beyond; 0.05 margins with sticky image
edges; the tab10 cycle), ``AutoLocator`` (``MaxNLocator`` with steps 1, 2,
2.5, 5, 10 and ``nbins`` from the axis length) and ``ScalarFormatter``
(offset, order of magnitude, U+2212 minus), ``Text._get_layout``, the
GridSpec geometry, ``tight_layout`` (``_auto_adjust_subplotpars``, pad
1.08 x the font size, suptitle included), the legend's packers and its
``loc="best"`` search (``_find_best_position`` over the same candidate
data), ``make_axes_gridspec`` for the colour bar, ``bbox_inches="tight"``
(pad 0.1 in) and the layout-at-100-dpi / redraw-at-save-dpi sequence.
Text metrics come from vis/plot_font.py (exact); Agg's pixel rules are
followed where they move pixels: path snapping of axis-aligned paths,
integer text origins (Python's ``round``), the text image's placement,
integer marker positions, a one-path collection drawn as a marker, the
integer clip box and Agg's 8-bit blend. csrc/plot2d.cpp fills by exact
signed area as Agg does, but strokes the pieces of a line (quads, discs
at the joins) on 16 sub-scanlines rather than as Agg's stroked outline,
and fills the glyph outlines itself rather than by FreeType: edges may
differ by a few levels. The image bound reached is stated in
tests/test_torch_plot.py.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import List, Optional

import numpy as np

from isdf_tpu_torch.utils import image_io, native
from isdf_tpu_torch.vis import colormaps, plot_font
from isdf_tpu_torch.vis.slices import VIRIDIS

FONT_SIZE = 10.0
_SCALE = {"xx-small": 0.579, "x-small": 0.694, "small": 0.833,
          "medium": 1.0, "large": 1.2, "x-large": 1.44, "xx-large": 1.728}
LINE_WIDTH = 1.5
AXES_LINE_WIDTH = 0.8
TICK_SIZE, TICK_WIDTH, TICK_PAD = 3.5, 0.8, 3.5
LABEL_PAD, TITLE_PAD, OFFSET_PAD = 4.0, 6.0, 3.0
MARGIN = 0.05
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2,
               hspace=0.2)
DASHES = {"--": (3.7, 1.6), ":": (1.0, 1.65), "-.": (6.4, 1.6, 1.0, 1.6)}
_NAMED = {"k": "#000000", "black": "#000000", "w": "#ffffff",
          "white": "#ffffff", "gray": "#808080", "grey": "#808080"}
_CMAPS = {"viridis": VIRIDIS, "hot": colormaps.HOT}


def _size(s) -> float:
    return FONT_SIZE * _SCALE[s] if isinstance(s, str) else float(s)


def to_rgb(c) -> np.ndarray:
    """matplotlib colour spec -> RGB floats in [0, 1]."""
    if isinstance(c, str):
        if c in _NAMED:
            c = _NAMED[c]
        if len(c) == 2 and c[0] == "C" and c[1].isdigit():
            c = colormaps.TAB10[int(c[1])]
        if c.startswith("#"):
            return np.array([int(c[i:i + 2], 16) for i in (1, 3, 5)],
                            np.float64) / 255
        return np.full(3, float(c))           # grey level, e.g. "0.8"
    return np.asarray(c, np.float64)[:3]


# ------------------------------------------------------------------ boxes
def _union(boxes):
    b = np.asarray(boxes, np.float64)
    return (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())


def _wh(b):
    return b[2] - b[0], b[3] - b[1]


def _nonzero(b):
    w, h = _wh(b)
    return 0 < w < np.inf and 0 < h < np.inf


# ------------------------------------------------------------------ ticks
def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    """transforms.nonsingular."""
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return vmin, vmax


def _edge_le(x, step, offset):
    d, m = divmod(x, step)
    return d + 1 if _close(m / step, 1, step, offset) else d


def _edge_ge(x, step, offset):
    d, m = divmod(x, step)
    return d if _close(m / step, 0, step, offset) else d + 1


def _close(ms, edge, step, offset):
    offset = abs(offset)
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(offset / step) - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


_STEPS = np.array([1, 2, 2.5, 5, 10])
_EXTENDED = np.concatenate([0.1 * _STEPS[:-1], _STEPS, [10 * _STEPS[1]]])


def auto_ticks(vmin, vmax, nbins):
    """AutoLocator().tick_values for an axis with ``nbins`` (its tick
    space, clipped to [1, 9])."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    nbins = int(np.clip(nbins, 1, 9))
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < 100:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _EXTENDED * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        low = _edge_le(_vmin - best_vmin, step, offset)
        high = _edge_ge(_vmax - best_vmin, step, offset)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def _fix_minus(s: str) -> str:
    return s.replace("-", "\N{MINUS SIGN}")


def _format_sci(value) -> str:
    """ScalarFormatter.format_data without mathtext."""
    e = math.floor(math.log10(abs(value)))
    s = round(value / 10 ** e, 10)
    sig = ("%d" if s % 1 == 0 else "%1.10g") % s
    return sig if e == 0 else f"{sig}e{e}"


def format_ticks(locs, vmin, vmax):
    """ScalarFormatter (useOffset, limits (-5, 6), no mathtext): the tick
    labels of ``locs`` and the offset text, for view limits vmin, vmax."""
    locs = np.asarray(locs, np.float64)
    if not len(locs):
        return [], ""
    vmin, vmax = sorted((vmin, vmax))
    inview = locs[(vmin <= locs) & (locs <= vmax)]
    offset = 0.0
    if len(inview):
        lmin, lmax = inview.min(), inview.max()
        if not (lmin == lmax or lmin <= 0 <= lmax):
            abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
            sign = math.copysign(1, lmin)
            oom_max = np.ceil(math.log10(abs_max))
            oom = 1 + next(o for o in itertools.count(oom_max, -1)
                           if abs_min // 10 ** o != abs_max // 10 ** o)
            if (abs_max - abs_min) / 10 ** oom <= 1e-2:
                oom = 1 + next(o for o in itertools.count(oom_max, -1)
                               if abs_max // 10 ** o - abs_min // 10 ** o > 1)
            offset = (sign * (abs_max // 10 ** oom) * 10 ** oom
                      if abs_max // 10 ** oom >= 10 ** 3 else 0)
    oom_mag = 0
    a = np.abs(inview)
    if len(a):
        if offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            val = a.max()
            oom = 0 if val == 0 else math.floor(math.log10(val))
        if oom <= -5 or oom >= 6:
            oom_mag = oom
    _locs = list(locs) + ([vmin, vmax] if len(locs) < 2 else [])
    ls = (np.asarray(_locs) - offset) / 10. ** oom_mag
    loc_range = np.ptp(ls)
    if loc_range == 0:
        loc_range = np.max(np.abs(ls))
    if loc_range == 0:
        loc_range = 1
    if len(locs) < 2:
        ls = ls[:-2]
    loc_range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - loc_range_oom)
    thresh = 1e-3 * 10 ** loc_range_oom
    while sigfigs >= 0:
        if np.abs(ls - np.round(ls, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    fmt = f"%1.{sigfigs + 1}f"
    labels = []
    for x in locs:
        xp = (x - offset) / (10. ** oom_mag)
        if abs(xp) < 1e-8:
            xp = 0
        labels.append(_fix_minus(fmt % xp))
    text = ""
    if oom_mag or offset:
        off_s = ""
        if offset:
            off_s = _format_sci(offset)
            if offset > 0:
                off_s = "+" + off_s
        sci = "1e%d" % oom_mag if oom_mag else ""
        text = _fix_minus(sci + off_s)
    return labels, text


# ------------------------------------------------------------------ text
class Text:
    """One matplotlib Text: ``pos(fig)`` gives its anchor in display
    pixels."""

    zorder = 3.0

    def __init__(self, pos, s, size=FONT_SIZE, style="normal", color="k",
                 ha="left", va="baseline", rotation=0.0,
                 rotation_mode="default", multialignment=None, zorder=3.0):
        self.pos, self.s = pos, str(s)
        self.size, self.style = _size(size), style
        self.rgb = to_rgb(color)
        self.ha, self.va = ha, va
        self.rotation = {"vertical": 90.0, "horizontal": 0.0}.get(
            rotation, rotation)
        self.rotation = float(self.rotation) % 360
        self.rotation_mode = rotation_mode
        self.malign = multialignment
        self.zorder = zorder

    def _layout(self, dpi):
        """Text._get_layout: box relative to the anchor, and each line's
        (text, origin offset)."""
        def ext(s):
            return plot_font.text_extent(s, self.size, dpi, self.style)
        _, lp_h, lp_d = ext("lp")
        min_dy = (lp_h - lp_d) * 1.2
        lines = self.s.split("\n")
        ws, ys = [], []
        thisy = 0.0
        for i, line in enumerate(lines):
            w, h, d = ext(line) if line else (0.0, 0.0, 0.0)
            h, d = max(h, lp_h), max(d, lp_d)
            ws.append(w)
            baseline = (h - d) - thisy
            if i == 0:
                thisy = -(h - d)
            else:
                thisy -= max(min_dy, (h - d) * 1.2)
            ys.append(thisy)
            thisy -= d
        descent = d
        width = max(ws)
        ymin = ys[-1] - descent
        th = math.radians(self.rotation)
        M = np.array([[math.cos(th), -math.sin(th)],
                      [math.sin(th), math.cos(th)]])
        malign = self.malign or self.ha
        horiz = []
        for y, w in zip(ys, ws):
            off = {"left": 0, "center": (width - w) / 2,
                   "right": width - w}[malign]
            horiz.append((off, y))
        corners = np.array([(0, ymin), (0, 0), (width, 0), (width, ymin)])
        rot = corners @ M.T
        xmin, xmax = rot[:, 0].min(), rot[:, 0].max()
        ymn, ymx = rot[:, 1].min(), rot[:, 1].max()
        W, H = xmax - xmin, ymx - ymn
        ha, va = self.ha, self.va
        if self.rotation_mode != "anchor":
            ox = {"center": (xmin + xmax) / 2, "right": xmax}.get(ha, xmin)
            oy = {"center": (ymn + ymx) / 2, "top": ymx,
                  "baseline": ymn + descent,
                  "center_baseline": ymn + H - baseline / 2.0}.get(va, ymn)
        else:
            xmin1, ymin1 = corners[0]
            xmax1, ymax1 = corners[2]
            ox = {"center": (xmin1 + xmax1) / 2.0, "right": xmax1}.get(
                ha, xmin1)
            oy = {"center": (ymin1 + ymax1) / 2.0, "top": ymax1,
                  "baseline": ymax1 - baseline,
                  "center_baseline": ymax1 - baseline / 2.0}.get(va, ymin1)
            ox, oy = M @ (ox, oy)
        box = (xmin - ox, ymn - oy, xmin - ox + W, ymn - oy + H)
        xys = np.asarray(horiz) @ M.T - (ox, oy)
        return box, list(zip(lines, xys))

    def window_extent(self, fig):
        x, y = self.pos(fig)
        if not self.s:
            return (x, y, x, y)
        b, _ = self._layout(fig.dpi)
        return (b[0] + x, b[1] + y, b[2] + x, b[3] + y)

    def draw(self, fig, canvas):
        if not self.s:
            return
        x, y = self.pos(fig)
        _, lines = self._layout(fig.dpi)
        for line, (dx, dy) in lines:
            if line:
                canvas.text(line, x + dx, y + dy, self.rotation, self.size,
                            self.style, self.rgb, fig.dpi)


# ------------------------------------------------------------------ canvas
class _Canvas:
    """The Agg canvas: RGB levels over white, paths in device pixels
    (x right, y down from the top of an ``H``-row image); ``hf`` is the
    float height Text flips its y with."""

    def __init__(self, w: int, h: int, hf: float):
        self.W, self.H, self.hf = int(w), int(h), hf
        self.img = np.full((self.H, self.W, 3), 255.0, np.float32)
        self.lib = native.load("plot2d")
        if self.lib is None:
            raise RuntimeError("vis/plot.py: csrc/plot2d.cpp did not build "
                               "(g++ is needed for the 2-D figures)")
        self.full = (0, 0, self.W, self.H)

    def dev(self, pts):
        """display (x, y up) -> device (x, y down)."""
        p = np.array(pts, np.float64, copy=True).reshape(-1, 2)
        p[:, 1] = self.H - p[:, 1]
        return p

    def clip_of(self, box):
        """Agg's clip box of a display bbox."""
        x0, y0, x1, y1 = box
        return (max(int(math.floor(x0 + 0.5)), 0),
                max(int(math.floor(self.H - y1 + 0.5)), 0),
                min(int(math.floor(x1 + 0.5)), self.W),
                min(int(math.floor(self.H - y0 + 0.5)), self.H))

    def _args(self, pieces):
        pieces = [np.ascontiguousarray(p, np.float64).reshape(-1, 2)
                  for p in pieces if len(p)]
        if not pieces:
            return None
        xy = np.ascontiguousarray(np.concatenate(pieces))
        offs = np.zeros(len(pieces) + 1, np.int64)
        offs[1:] = np.cumsum([len(p) for p in pieces])
        return xy, offs, len(pieces)

    def fill(self, rings, rgb, alpha=1.0, clip=None):
        a = self._args(rings)
        if a is None:
            return
        xy, offs, n = a
        c = np.asarray(clip or self.full, np.int32)
        col = np.ascontiguousarray(np.asarray(rgb) * 255, np.float32)
        self.lib.plot_fill(
            self.img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.H, self.W, xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
            col.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), float(alpha),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))

    def stroke(self, lines, width, rgb, alpha=1.0, cap=1, join=1,
               clip=None):
        a = self._args(lines)
        if a is None or width <= 0:
            return
        xy, offs, n = a
        c = np.asarray(clip or self.full, np.int32)
        col = np.ascontiguousarray(np.asarray(rgb) * 255, np.float32)
        self.lib.plot_stroke(
            self.img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.H, self.W, xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
            float(width), col.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            float(alpha), int(cap), int(join),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))

    def text(self, s, x, y, angle, size, style, rgb, dpi):
        """RendererAgg.draw_text: FreeType's string image placed at an
        integer origin (and turned a quarter for vertical text)."""
        f = plot_font.face(size, dpi, style)
        idx, pens, (bx0, by0, bx1, by1), _ = plot_font.layout(
            s, size, dpi, style)
        d = -by0 / 64.0
        X0 = bx0 / 64.0
        th = math.radians(angle)
        y_td = self.hf - y
        xr = round(x + X0 + d * math.sin(th))
        yr = round(y_td + d * math.cos(th))
        himg = (by1 - by0) // 64 + 2
        rings = []
        for i, pen in zip(idx, pens):
            left = (int(f.cbox[i][0]) + pen) // 64
            shift = left - int(left - X0)
            for r in f.rings(i):
                u = r[:, 0] + pen / 64.0 - shift     # image column
                v = by1 / 64.0 + 1 - r[:, 1]         # image row (down)
                if angle == 0:
                    rings.append(np.stack([xr + u, yr + 1 - himg + v], -1))
                elif angle == 90:
                    rings.append(np.stack([xr + v - himg, yr + 1 - u], -1))
                else:
                    raise ValueError("text at 0 or 90 degrees only")
        self.fill(rings, rgb)

    def image(self, rgb, x0, y0, clip=None):
        """RendererAgg.draw_image of an opaque RGB [h, w, 3] image whose
        lower-left corner is at display (x0, y0), rounded to a pixel,
        inside the clip box."""
        h, w = rgb.shape[:2]
        x0, y0 = math.floor(x0 + 0.5), math.floor(y0 + 0.5)
        c0, r0 = int(x0), int(self.H - (y0 + h))
        k = clip or self.full
        cs, rs = max(c0, k[0]), max(r0, k[1])
        ce, re_ = min(c0 + w, k[2]), min(r0 + h, k[3])
        if ce > cs and re_ > rs:
            self.img[rs:re_, cs:ce] = rgb[rs - r0:re_ - r0, cs - c0:ce - c0]

    def rgba8(self) -> np.ndarray:
        a = np.clip(np.rint(self.img), 0, 255).astype(np.uint8)
        return np.concatenate([a, np.full(a.shape[:2] + (1,), 255,
                                          np.uint8)], -1)


def _snap(dev, width_px):
    """Agg's PathSnapper in auto mode: a path of horizontal and vertical
    segments only has its vertices moved to pixel centres (odd widths) or
    corners (even widths)."""
    if len(dev) > 1024 or len(dev) < 2:
        return dev
    d = np.abs(np.diff(dev, axis=0))
    ok = np.isfinite(d).all(1)
    if ((d[ok, 0] >= 1e-4) & (d[ok, 1] >= 1e-4)).any():
        return dev
    sv = 0.5 if int(math.floor(width_px + 0.5)) % 2 else 0.0
    return np.floor(dev + 0.5) + sv


def _dash(dev, pattern_px):
    """Agg's conv_dash from offset 0: the on-pieces of a polyline."""
    out = []
    segs = [dev]
    if not np.isfinite(dev).all():
        ok = np.isfinite(dev).all(1)
        segs, cur = [], []
        for p, g in zip(dev, ok):
            if g:
                cur.append(p)
            elif cur:
                segs.append(np.asarray(cur))
                cur = []
        if cur:
            segs.append(np.asarray(cur))
    for seg in segs:
        if len(seg) < 2:
            continue
        k, left, on = 0, pattern_px[0], True
        cur = [seg[0]] if on else []
        for a, b in zip(seg[:-1], seg[1:]):
            L = float(np.hypot(*(b - a)))
            pos = 0.0
            while L - pos > left:
                pos += left
                p = a + (b - a) * (pos / L)
                if on:
                    cur.append(p)
                    out.append(np.asarray(cur))
                    cur = []
                else:
                    cur = [p]
                on = not on
                k = (k + 1) % len(pattern_px)
                left = pattern_px[k]
            left -= L - pos
            if on:
                cur.append(b)
        if on and len(cur) > 1:
            out.append(np.asarray(cur))
    return out


def _draw_line(canvas, pts, lw_pt, rgb, dpi, ls="-", alpha=1.0, clip=None,
               solid_cap=1):
    w = lw_pt * dpi / 72.0
    dev = _snap(canvas.dev(pts), w)
    if ls in ("-", "solid"):
        canvas.stroke([dev], w, rgb, alpha, cap=solid_cap, join=1,
                      clip=clip)
    elif ls in DASHES:
        pat = [v * lw_pt * dpi / 72.0 for v in DASHES[ls]]
        canvas.stroke(_dash(dev, pat), w, rgb, alpha, cap=0, join=1,
                      clip=clip)


def _circle(r, n=48):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([np.cos(t) * r, np.sin(t) * r], -1)


def _draw_points(canvas, pts, ms_pt, rgb, dpi, clip=None):
    """The '.' marker: a disc of radius ms/4 pt with a 1-pt edge of the same
    colour, centred on the pixel the point rounds to (RendererAgg.
    draw_markers: a marker path that does not snap is moved half a pixel)."""
    dev = canvas.dev(pts)
    dev = dev[np.isfinite(dev).all(1)]
    r = 0.25 * ms_pt * dpi / 72.0
    ew = 1.0 * dpi / 72.0
    for p in np.floor(dev + 0.5) + 0.5:    # draw_markers: pixel centres
        c = _circle(r) + p
        canvas.fill([c], rgb, clip=clip)
        canvas.stroke([np.vstack([c, c[:1]])], ew, rgb, cap=0, join=1,
                      clip=clip)


# ------------------------------------------------------------------ grids
class GridSpec:
    def __init__(self, fig, nrows, ncols, height_ratios=None,
                 width_ratios=None, wspace=None, hspace=None, parent=None):
        self.fig, self.nrows, self.ncols = fig, nrows, ncols
        self.height_ratios = list(height_ratios or [1] * nrows)
        self.width_ratios = list(width_ratios or [1] * ncols)
        self.wspace, self.hspace, self.parent = wspace, hspace, parent

    def __getitem__(self, key):
        r, c = key

        def span(k, n):
            if isinstance(k, slice):
                a, b, _ = k.indices(n)
                return a, b
            k = k % n
            return k, k + 1
        return SubplotSpec(self, span(r, self.nrows), span(c, self.ncols))

    def grid_positions(self):
        """GridSpec.get_grid_positions: (bottoms, tops, lefts, rights)."""
        if self.parent is None:
            p = self.fig.subplotpars
            left, right, bottom, top = (p["left"], p["right"], p["bottom"],
                                        p["top"])
        else:
            left, bottom, right, top = self.parent.position()
        p = self.fig.subplotpars
        wspace = p["wspace"] if self.wspace is None else self.wspace
        hspace = p["hspace"] if self.hspace is None else self.hspace
        nr, nc = self.nrows, self.ncols
        cell_h = (top - bottom) / (nr + hspace * (nr - 1))
        norm = cell_h * nr / sum(self.height_ratios)
        heights = [r * norm for r in self.height_ratios]
        seps = [0] + [hspace * cell_h] * (nr - 1)
        cell_hs = np.cumsum(np.column_stack([seps, heights]).flat)
        cell_w = (right - left) / (nc + wspace * (nc - 1))
        norm = cell_w * nc / sum(self.width_ratios)
        widths = [r * norm for r in self.width_ratios]
        seps = [0] + [wspace * cell_w] * (nc - 1)
        cell_ws = np.cumsum(np.column_stack([seps, widths]).flat)
        tops, bottoms = (top - cell_hs).reshape((-1, 2)).T
        lefts, rights = (left + cell_ws).reshape((-1, 2)).T
        return bottoms, tops, lefts, rights


class SubplotSpec:
    def __init__(self, gs, rows, cols):
        self.gs, self.rows, self.cols = gs, rows, cols

    def position(self):
        """(left, bottom, right, top) in figure fractions."""
        b, t, l, r = self.gs.grid_positions()
        rs, cs = slice(*self.rows), slice(*self.cols)
        return (min(l[cs]), min(b[rs]), max(r[cs]), max(t[rs]))

    def topmost(self):
        ss = self
        while ss.gs.parent is not None:
            ss = ss.gs.parent
        return ss

    def key(self):
        return (id(self.gs), self.rows, self.cols)


# ------------------------------------------------------------------ artists
class _Line:
    zorder = 2.0

    def __init__(self, x, y, color, lw, ls, marker, label):
        self.x = np.asarray(x, np.float64).ravel()
        self.y = np.asarray(y, np.float64).ravel()
        self.rgb, self.lw, self.ls = to_rgb(color), float(lw), ls
        self.marker, self.label = marker, label


class _Fill:
    zorder = 1.0

    def __init__(self, verts, color, alpha, edge):
        self.verts, self.rgb, self.alpha, self.edge = (verts, to_rgb(color),
                                                       alpha, edge)


class _Segments:
    zorder = 2.0

    def __init__(self, segs, color, lw, ls):
        self.segs, self.rgb, self.lw, self.ls = segs, to_rgb(color), lw, ls


class _Image:
    zorder = 0.0

    def __init__(self, data, extent, cmap, interpolation, zorder):
        self.data = np.asarray(data, np.float64)
        self.extent = tuple(float(v) for v in extent)
        self.table = _CMAPS[cmap]
        self.interpolation = interpolation
        self.zorder = float(zorder if zorder is not None else 0.0)
        finite = self.data[np.isfinite(self.data)]
        self.vmin = float(finite.min()) if finite.size else 0.0
        self.vmax = float(finite.max()) if finite.size else 1.0

    def rgb(self, data):
        """Normalize (0 where vmin == vmax) and the colour table."""
        if self.vmin == self.vmax:
            return colormaps.lookup(self.table, np.zeros_like(data))
        return colormaps.lookup(self.table, (data - self.vmin)
                                / (self.vmax - self.vmin))


# ------------------------------------------------------------------ legend
def _packed(sizes, sep):
    offs = np.cumsum([0] + [w + sep for w in sizes])
    return offs[-1] - sep, offs[:-1]


class _Legend:
    zorder = 5.0

    def __init__(self, ax, fontsize, ncol):
        self.ax, self.fontsize, self.ncol = ax, _size(fontsize), max(
            int(ncol), 1)
        self.handles = [a for a in ax.artists if isinstance(a, _Line)
                        and a.label and not a.label.startswith("_")]

    def _text_box(self, label, dpi):
        """TextArea.get_bbox of a one-line label: (x0, y0, x1, y1)."""
        t = Text(None, label, self.fontsize)
        _, h_, d_ = plot_font.text_extent("lp", self.fontsize, dpi)
        box, _ = t._layout(dpi)
        w, h = _wh(box)
        yd = -box[1]
        h = max(h_ - d_, h - yd) + yd
        return (0.0, -yd, w, h - yd)

    def layout(self, dpi):
        """The packed legend box (relative to its offset) and each entry's
        (handle box offset, text offset)."""
        fs = self.fontsize
        cor = dpi / 72.0
        hb = (0.0, 0.0, 2.0 * fs * cor, 0.7 * fs * cor)
        items = []
        for h in self.handles:
            tb = self._text_box(h.label, dpi)
            y0, y1 = min(hb[1], tb[1]), max(hb[3], tb[3])
            width, xo = _packed([hb[2] - hb[0], tb[2] - tb[0]],
                                0.8 * fs * cor)
            items.append(((0.0, y0, width, y1), [(xo[0], 0.0),
                                                  (xo[1], 0.0)]))
        cols = [c for c in np.array_split(np.arange(len(items)), self.ncol)
                if len(c)]
        col_boxes = []
        for c in cols:
            boxes = [items[i][0] for i in c]
            x0, x1 = min(b[0] for b in boxes), max(b[2] for b in boxes)
            height, yo = _packed([b[3] - b[1] for b in boxes],
                                 0.5 * fs * cor)
            yo = height - (yo + np.array([b[3] for b in boxes]))
            ydesc = yo[0]
            yo = yo - ydesc
            col_boxes.append(((x0, -ydesc, x1, -ydesc + height),
                              [(0.0, y) for y in yo]))
        if col_boxes:
            y0 = min(b[0][1] for b in col_boxes)
            y1 = max(b[0][3] for b in col_boxes)
            width, xo = _packed([b[0][2] - b[0][0] for b in col_boxes],
                                2.0 * fs * cor)
            x0 = col_boxes[0][0][0]
            xo = xo - (np.array([b[0][0] for b in col_boxes]) - x0)
            hbox = (x0, y0, x0 + width, y1)
        else:
            hbox, xo = (0.0, 0.0, 0.0, 0.0), []
        # the outer VPacker: one child, centred, padded
        pad = 0.4 * fs * cor
        height = hbox[3] - hbox[1]
        yo_h = height - (0 + hbox[3])
        ydesc = yo_h
        box = (hbox[0] - pad, -ydesc - pad, hbox[2] + pad,
               -ydesc + height + pad)
        hoff = (0.0, yo_h - ydesc)
        entries = []
        for (cb, coffs), c, cx in zip(col_boxes, cols, xo):
            for (ix, iy), i in zip(coffs, c):
                ib, ioffs = items[i]
                base = (hoff[0] + cx + ix, hoff[1] + iy)
                entries.append((self.handles[i],
                                (base[0] + ioffs[0][0], base[1]),
                                (base[0] + ioffs[1][0], base[1])))
        return box, entries

    def _data(self, fig):
        """Legend._auto_legend_data: line vertices and text boxes."""
        ax = self.ax
        lines, bboxes = [], []
        for a in ax.artists:
            if isinstance(a, _Line):
                lines.append(ax.to_display(np.stack([a.x, a.y], -1)))
            elif isinstance(a, _Fill):
                v = np.vstack([a.verts, a.verts[:1]])
                lines.append(ax.to_display(v))
            elif isinstance(a, Text):
                bboxes.append(a.window_extent(fig))
        return lines, bboxes

    def window_extent(self, fig):
        box, _ = self.layout(fig.dpi)
        l, b, _ = self._place(fig, box)
        return (l, b, l + box[2] - box[0], b + box[3] - box[1])

    def _place(self, fig, box):
        """Legend._find_best_position: (left, bottom) of the box."""
        w, h = _wh(box)
        pad = 0.5 * self.fontsize * fig.dpi / 72.0
        x0, y0, x1, y1 = self.ax.bbox(fig)
        cx0, cy0, cx1, cy1 = x0 + pad, y0 + pad, x1 - pad, y1 - pad
        coefs = [None, (1, 1), (0, 1), (0, 0), (1, 0), (1, .5), (0, .5),
                 (1, .5), (.5, 0), (.5, 1), (.5, .5)]
        lines, bboxes = self._data(fig)
        cands = []
        for idx in range(1, 11):
            ax_, ay_ = coefs[idx]
            l = cx0 + ax_ * ((cx1 - cx0) - w)
            b = cy0 + ay_ * ((cy1 - cy0) - h)
            lb = (l, b, l + w, b + h)
            bad = sum(_count_contains(lb, v) for v in lines)
            bad += sum(_overlaps(lb, bb) for bb in bboxes)
            bad += sum(_path_hits_box(v, lb) for v in lines)
            cands.append((bad, idx, (l, b)))
            if bad == 0:
                break
        bad, idx, (l, b) = min(cands)
        return l, b, idx

    def draw(self, fig, canvas):
        dpi = fig.dpi
        box, entries = self.layout(dpi)
        l, b, _ = self._place(fig, box)
        ox, oy = l - box[0], b - box[1]
        w, h = _wh(box)
        # the frame: FancyBboxPatch "round,pad=0,rounding_size=0.2", white
        # at alpha 0.8 with a 1-pt '0.8' edge, snapped
        fs_px = self.fontsize * dpi / 72.0
        dr = 0.2 * fs_px
        x0, y0, x1, y1 = l, b, l + w, b + h
        cp = [(x0 + dr, y0), (x1 - dr, y0), (x1, y0), (x1, y0 + dr),
              (x1, y1 - dr), (x1, y1), (x1 - dr, y1), (x0 + dr, y1),
              (x0, y1), (x0, y1 - dr), (x0, y0 + dr), (x0, y0),
              (x0 + dr, y0)]
        ew = 1.0 * dpi / 72.0
        dev = canvas.dev(cp)
        sv = 0.5 if int(math.floor(ew + 0.5)) % 2 else 0.0
        dev = np.floor(dev + 0.5) + sv
        t = np.linspace(0, 1, 9)[1:, None]
        path = [dev[0], dev[1]]
        for k in (1, 4, 7, 10):
            p0, p1, p2 = dev[k], dev[k + 1], dev[k + 2]
            path.extend((1 - t) ** 2 * p0 + 2 * (1 - t) * t * p1
                        + t ** 2 * p2)
            if k + 3 < len(dev):
                path.append(dev[k + 3])
        path = np.asarray(path)
        canvas.fill([path], np.ones(3), 0.8)
        canvas.stroke([np.vstack([path, path[:1]])], ew, np.full(3, 0.8),
                      0.8, cap=0, join=1)
        cor = dpi / 72.0
        fs = self.fontsize
        for line, (hx, hy), (tx, ty) in entries:
            y = oy + hy + 0.35 * fs * cor
            pts = np.array([[ox + hx, y], [ox + hx + 2.0 * fs * cor, y]])
            if line.ls != "None":
                _draw_line(canvas, pts, line.lw, line.rgb, dpi, line.ls)
            if line.marker == ".":
                _draw_points(canvas, pts.mean(0, keepdims=True), 6.0,
                             line.rgb, dpi)
            canvas.text(line.label, ox + tx, oy + ty, 0, fs, "normal",
                        np.zeros(3), dpi)


def _count_contains(b, v):
    v = np.asarray(v)
    if not len(v):
        return 0
    with np.errstate(invalid="ignore"):
        return int(((b[0] < v[:, 0]) & (v[:, 0] < b[2]) & (b[1] < v[:, 1])
                    & (v[:, 1] < b[3])).sum())


def _overlaps(a, b):
    return not (b[2] <= a[0] or b[0] >= a[2] or b[3] <= a[1]
                or b[1] >= a[3])


def _path_hits_box(v, b):
    """_path.path_intersects_rectangle(filled=False) of a polyline."""
    v = np.asarray(v, np.float64)
    v = v[np.isfinite(v).all(1)]
    if not len(v):
        return False
    cx, cy = (b[0] + b[2]) * 0.5, (b[1] + b[3]) * 0.5
    w, h = abs(b[0] - b[2]), abs(b[1] - b[3])
    if 2.0 * abs(v[0, 0] - cx) <= w and 2.0 * abs(v[0, 1] - cy) <= h:
        return True
    x1, y1, x2, y2 = v[:-1, 0], v[:-1, 1], v[1:, 0], v[1:, 1]
    hit = ((np.abs(x1 + x2 - 2.0 * cx) < np.abs(x1 - x2) + w)
           & (np.abs(y1 + y2 - 2.0 * cy) < np.abs(y1 - y2) + h)
           & (2.0 * np.abs((x1 - cx) * (y1 - y2) - (y1 - cy) * (x1 - x2))
              < w * np.abs(y1 - y2) + h * np.abs(x1 - x2)))
    return bool(hit.any())


# ------------------------------------------------------------------ axes
class Axes:
    def __init__(self, fig, spec: SubplotSpec):
        self.fig, self.spec = fig, spec
        self.artists: List[object] = []
        self.visible = True
        self.lim = {"x": None, "y": None}
        self.auto = {"x": True, "y": True}
        self.fixed = {"x": None, "y": None}     # (locs, labels, size)
        self.title = Text(self._title_pos, "", "large", ha="center")
        self.xlabel = Text(self._xlabel_pos, "", ha="center", va="top")
        self.ylabel = Text(self._ylabel_pos, "", ha="center", va="bottom",
                           rotation=90, rotation_mode="anchor")
        self.legend_: Optional[_Legend] = None
        self._cycle = 0
        self._fill_cycle = 0
        self.box_aspect = None
        self.cbar = None            # (image) for a colour bar's axes
        self._title_y = None

    # ---- geometry
    def position(self):
        """The active position (figure fractions): the subplot spec's,
        shrunk to the box aspect and anchored west for a colour bar."""
        l, b, r, t = self.spec.position()
        if self.box_aspect is None:
            return (l, b, r, t)
        fw, fh = self.fig.figsize
        w, h = r - l, t - b
        fig_aspect = fh / fw
        H = w * self.box_aspect / fig_aspect
        if H <= h:
            W = w
        else:
            H, W = h, h * fig_aspect / self.box_aspect
        y0 = b + 0.5 * (h - H)
        return (l, y0, l + W, y0 + H)

    def bbox(self, fig):
        l, b, r, t = self.position()
        return fig.frac_to_display(l, b) + fig.frac_to_display(r, t)

    def view(self, a):
        if self.lim[a] is None or self.auto[a]:
            return self._autoscale(a)
        return self.lim[a]

    def _autoscale(self, a):
        if not any(isinstance(art, (_Line, _Fill, _Segments, _Image))
                   for art in self.artists):
            return self.lim[a] or (0.0, 1.0)      # the default view
        vals, sticky = [], []
        for art in self.artists:
            if isinstance(art, _Line):
                v = art.x if a == "x" else art.y
                vals.append(v[np.isfinite(v)])
            elif isinstance(art, _Fill):
                v = art.verts[:, 0 if a == "x" else 1]
                vals.append(v[np.isfinite(v)])
            elif isinstance(art, _Segments):
                v = art.segs[..., 0 if a == "x" else 1].ravel()
                vals.append(v[np.isfinite(v)])
            elif isinstance(art, _Image):
                e = art.extent[:2] if a == "x" else art.extent[2:]
                vals.append(np.asarray(e))
                sticky.extend(e)
        vals = [v for v in vals if len(v)]
        if vals:
            allv = np.concatenate(vals)
            x0, x1 = float(allv.min()), float(allv.max())
        elif self.lim[a] is not None:
            return self.lim[a]
        else:
            x0, x1 = -np.inf, np.inf
        x0, x1 = nonsingular(x0, x1, expander=0.05)
        stickies = np.sort(np.asarray(sticky, np.float64))
        tol = 1e-5 * abs(x1 - x0)
        i0 = stickies.searchsorted(x0 + tol) - 1
        x0b = stickies[i0] if i0 != -1 else None
        i1 = stickies.searchsorted(x1 - tol)
        x1b = stickies[i1] if i1 != len(stickies) else None
        delta = (x1 - x0) * MARGIN
        if not np.isfinite(delta):
            delta = 0
        x0, x1 = x0 - delta, x1 + delta
        if x0b is not None:
            x0 = max(x0, x0b)
        if x1b is not None:
            x1 = min(x1, x1b)
        return nonsingular(x0, x1, expander=1e-12, tiny=1e-13)

    def to_display(self, xy):
        """transData: transLimits then transAxes, as matplotlib composes
        the two affine matrices (so pixel-edge cases round alike)."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        x0, y0, x1, y1 = self.bbox(self.fig)
        out = np.empty_like(xy)
        for k, (v, lo, hi) in enumerate(((self.view("x"), x0, x1),
                                         (self.view("y"), y0, y1))):
            s = 1.0 / (v[1] - v[0])
            w = hi - lo
            out[:, k] = xy[:, k] * (w * s) + (w * (-v[0] * s) + lo)
        return out

    # ---- ticks
    def _tick_space(self, a):
        x0, y0, x1, y1 = self.position()
        fw, fh = self.fig.figsize
        if a == "x":
            return int(np.floor((x1 - x0) * fw * 72 / (FONT_SIZE * 3)))
        return int(np.floor((y1 - y0) * fh * 72 / (FONT_SIZE * 2)))

    def ticks(self, a):
        """(all locations, labels, offset text, label size) of the axis:
        ``get_xticks()`` and the labels' texts."""
        if self.fixed[a] is not None:
            locs, labels, size = self.fixed[a]
            return np.asarray(locs, np.float64), list(labels), "", size
        v = self.view(a)
        locs = auto_ticks(v[0], v[1], self._tick_space(a))
        labels, off = format_ticks(locs, v[0], v[1])
        return locs, labels, off, FONT_SIZE

    def _drawn_ticks(self, a):
        locs, labels, off, size = self.ticks(a)
        k = 0 if a == "x" else 1
        v = sorted(self.view(a))
        pts = np.zeros((len(locs) + 2, 2))
        pts[:, k] = np.concatenate([locs, v])
        t = self.to_display(pts)[:, k]
        lo, hi = t[-2], t[-1]
        t = t[:-2]
        tol = 1e-10 * (hi - lo)
        keep = (t >= lo - tol) & (t <= hi + tol)
        return ([(p, lab) for p, lab, k in zip(t, labels, keep) if k],
                off, size)

    def _tick_labels(self, a):
        fig = self.fig
        dpi = fig.dpi
        x0, y0, x1, y1 = self.bbox(fig)
        pad = (TICK_PAD + TICK_SIZE) / 72 * dpi
        x0, y0 = self.axes_to_display(fig, 0.0, 0.0)
        x1, y1 = self.axes_to_display(fig, 1.0, 1.0)
        out = []
        ticks, _, size = self._drawn_ticks(a)
        right = self.cbar is not None
        for p, lab in ticks:
            if a == "x":
                out.append(Text(lambda f, p=p, y=y0 - pad: (p, y), lab, size,
                                ha="center", va="top"))
            elif right:
                out.append(Text(lambda f, p=p, x=x1 + pad: (x, p), lab, size,
                                ha="left", va="center_baseline"))
            else:
                out.append(Text(lambda f, p=p, x=x0 - pad: (x, p), lab, size,
                                ha="right", va="center_baseline"))
        return out

    def _spine_extent(self, a):
        """Spine.get_window_extent: the line, grown by the tick length
        where ticks are drawn."""
        x0, y0, x1, y1 = self.bbox(self.fig)
        L = TICK_SIZE * self.fig.dpi / 72.0
        has = bool(self._drawn_ticks(a)[0])
        if a == "x":
            return (x0, y0 - (L if has else 0), x1, y0)
        if self.cbar is not None:
            return (x1, y0, x1 + (L if has else 0), y1)
        return (x0 - (L if has else 0), y0, x0, y1)

    def _offset_text(self, a, tlb):
        fig = self.fig
        _, off, _ = self._drawn_ticks(a)
        x0, y0, x1, y1 = self.bbox(fig)
        pad = OFFSET_PAD * fig.dpi / 72.0
        if a == "y":
            if self.cbar is not None:
                return Text(lambda f: (x1, y1 + pad), off, FONT_SIZE,
                            ha="right", va="baseline")
            return Text(lambda f: (x0, y1 + pad), off, FONT_SIZE,
                        ha="left", va="baseline")
        bottom = _union(tlb + [self._spine_extent("x")])[1]
        return Text(lambda f: (x1, bottom - pad), off, FONT_SIZE,
                    ha="right", va="top")

    def _xlabel_pos(self, fig):
        x0, y0, x1, y1 = self.bbox(fig)
        tlb = [t.window_extent(fig) for t in self._tick_labels("x")]
        b = _union(tlb + [self._spine_extent("x")])
        return ((x0 + x1) / 2, b[1] - LABEL_PAD * fig.dpi / 72.0)

    def _ylabel_pos(self, fig):
        x0, y0, x1, y1 = self.bbox(fig)
        tlb = [t.window_extent(fig) for t in self._tick_labels("y")]
        b = _union(tlb + [self._spine_extent("y")])
        return (b[0] - LABEL_PAD * fig.dpi / 72.0, (y0 + y1) / 2)

    def axes_to_display(self, fig, fx, fy):
        """transAxes (matplotlib's affine, in its order of operations)."""
        x0, y0, x1, y1 = self.bbox(fig)
        return fx * (x1 - x0) + x0, fy * (y1 - y0) + y0

    def _title_pos(self, fig):
        x, y = self.axes_to_display(fig, 0.5, 1.0)
        base = x, y + TITLE_PAD / 72 * fig.dpi
        if self._title_y is not None:
            return base[0], self._title_y
        return base

    def _update_title(self, fig):
        """_update_title_position: lift the title over the y-axis offset
        text where they overlap."""
        self._title_y = None
        if not self.title.s:
            return
        x0, y0, x1, y1 = self.bbox(fig)
        top = y1
        ot = self._offset_text("y", [])
        if ot.s:
            bb = ot.window_extent(fig)
            tb = self.title.window_extent(fig)
            if not (bb[2] < tb[0] or bb[0] > tb[2] or bb[3] < tb[1]
                    or bb[1] > tb[3]):
                top = bb[3]
        pad = TITLE_PAD / 72 * fig.dpi
        tb = self.title.window_extent(fig)
        if tb[1] < top:       # the title's anchor moves to the top
            self._title_y = top + pad
            tb = self.title.window_extent(fig)
            if tb[1] < top:
                self._title_y = 2 * top - tb[1] + pad

    def tight_bbox(self, fig, for_layout_only=True):
        """Axes.get_tightbbox."""
        bb = []
        for a in ("x", "y"):
            if self.cbar is not None and a == "x":
                continue
            tl = self._tick_labels(a)
            tlb = [t.window_extent(fig) for t in tl]
            boxes = [self._offset_text(a, tlb).window_extent(fig)] + tlb
            lab = self.xlabel if a == "x" else self.ylabel
            if lab.s:
                b = list(lab.window_extent(fig))
                if for_layout_only:
                    if a == "x" and b[2] - b[0] > 0:
                        b[0] = (b[0] + b[2]) / 2 - 0.5
                        b[2] = b[0] + 1.0
                    if a == "y" and b[3] - b[1] > 0:
                        b[1] = (b[1] + b[3]) / 2 - 0.5
                        b[3] = b[1] + 1.0
                boxes.append(tuple(b))
            boxes = [b for b in boxes if _nonzero(b)]
            if boxes:
                bb.append(_union(boxes))
        self._update_title(fig)
        bb.append(self.bbox(fig))
        if self.title.s:
            b = list(self.title.window_extent(fig))
            if for_layout_only and b[2] - b[0] > 0:
                b[0] = (b[0] + b[2]) / 2 - 0.5
                b[2] = b[0] + 1.0
            bb.append(tuple(b))
        if self.cbar is None:
            extra = [self._spine_extent(a) for a in ("x", "y")]
            extra += [self._spine_extent2(s) for s in ("top", "right")]
        else:                   # a colour bar: its outline, no spines
            extra = [self.bbox(fig)]
        for art in self.artists:
            if isinstance(art, Text):
                extra.append(art.window_extent(fig))
        if self.legend_ is not None:
            extra.append(self.legend_.window_extent(fig))
        bb += [b for b in extra if _nonzero(b)]
        return _union([b for b in bb if _wh(b)[0] != 0 or _wh(b)[1] != 0])

    def _spine_extent2(self, side):
        x0, y0, x1, y1 = self.bbox(self.fig)
        return (x0, y1, x1, y1) if side == "top" else (x1, y0, x1, y1)

    # ---- the matplotlib calls
    def plot(self, x, y, fmt="-", color=None, lw=None, linewidth=None,
             linestyle=None, label=None):
        marker = "." if fmt.startswith(".") else None
        ls = fmt[1:] if marker else fmt
        if marker and not ls:
            ls = "None"
        ls = linestyle or ls
        if color is None:
            color = f"C{self._cycle % 10}"
            self._cycle += 1
        width = lw if lw is not None else linewidth
        self.artists.append(_Line(x, y, color, LINE_WIDTH if width is None
                                  else width, ls, marker,
                                  None if label is None else str(label)))

    def fill_between(self, x, y1, y2, alpha=None, color=None):
        x, y1, y2 = (np.asarray(v, np.float64).ravel() for v in
                     np.broadcast_arrays(x, y1, y2))
        edge = color is not None
        if color is None:
            color = f"C{self._fill_cycle % 10}"
            self._fill_cycle += 1
        verts = np.concatenate([[[x[0], y2[0]]], np.stack([x, y1], -1),
                                [[x[-1], y2[-1]]],
                                np.stack([x, y2], -1)[::-1]])
        self.artists.append(_Fill(verts, color, 1.0 if alpha is None
                                  else alpha, edge))

    def hlines(self, y, xmin, xmax, color="k", linestyle="-", lw=None):
        y, xmin, xmax = np.broadcast_arrays(np.atleast_1d(y), xmin, xmax)
        segs = np.stack([np.stack([xmin, y], -1), np.stack([xmax, y], -1)],
                        1).astype(np.float64)
        self.artists.append(_Segments(segs, color, LINE_WIDTH if lw is None
                                      else lw, linestyle))

    def vlines(self, x, ymin, ymax, color="k", linestyle="-", lw=None):
        x, ymin, ymax = np.broadcast_arrays(np.atleast_1d(x), ymin, ymax)
        segs = np.stack([np.stack([x, ymin], -1), np.stack([x, ymax], -1)],
                        1).astype(np.float64)
        self.artists.append(_Segments(segs, color, LINE_WIDTH if lw is None
                                      else lw, linestyle))

    def imshow(self, data, extent=None, aspect="auto", origin="upper",
               interpolation=None, cmap="viridis", zorder=None):
        if aspect != "auto":
            raise ValueError("imshow: aspect='auto' only")
        data = np.asarray(data, np.float64)
        if origin == "upper":
            data = data[::-1]
        if extent is None:
            h, w = data.shape[:2]
            extent = (-0.5, w - 0.5, -0.5, h - 0.5)
        im = _Image(data, extent, cmap, interpolation, zorder)
        self.artists.append(im)
        return im

    def legend(self, fontsize="medium", ncol=1):
        self.legend_ = _Legend(self, fontsize, ncol)
        return self.legend_

    def annotate(self, s, xy, xycoords="axes fraction", ha="left",
                 fontsize=FONT_SIZE, color="k"):
        if xycoords != "axes fraction":
            raise ValueError("annotate: xycoords='axes fraction' only")

        def pos(fig, xy=xy):
            return self.axes_to_display(fig, *xy)
        self.artists.append(Text(pos, s, fontsize, color=color, ha=ha))

    def set_title(self, s, style="normal", fontsize="large"):
        self.title.s, self.title.style = str(s), style
        self.title.size = _size(fontsize)

    def set_xlabel(self, s, fontsize=FONT_SIZE):
        self.xlabel.s, self.xlabel.size = str(s), _size(fontsize)

    def set_ylabel(self, s, fontsize=FONT_SIZE):
        self.ylabel.s, self.ylabel.size = str(s), _size(fontsize)

    def set_xticks(self, ticks, labels=None, fontsize=FONT_SIZE):
        ticks = list(ticks)
        if labels is None:
            v = self.view("x")
            labels, _ = format_ticks(ticks, *v)
        self.fixed["x"] = (ticks, [str(s) for s in labels], _size(fontsize))

    def set_yticks(self, ticks):
        ticks = list(ticks)
        labels, _ = format_ticks(ticks, *self.view("y"))
        self.fixed["y"] = (ticks, labels, FONT_SIZE)

    def set_xlim(self, lo, hi):
        self.lim["x"], self.auto["x"] = (float(lo), float(hi)), False

    def set_ylim(self, lo, hi):
        self.lim["y"], self.auto["y"] = (float(lo), float(hi)), False

    def set_visible(self, b):
        self.visible = bool(b)

    # ---- drawing
    def draw(self, canvas):
        fig = self.fig
        dpi = fig.dpi
        box = self.bbox(fig)
        clip = canvas.clip_of(box)
        self._update_title(fig)
        items = [(a.zorder, i, a) for i, a in enumerate(self.artists)]
        n = len(items)
        items += [(2.5, n, "spines"), (1.5, n + 1, "axis")]
        items += [(3.0, n + 2, self.title)]
        if self.legend_ is not None:
            items.append((5.0, n + 3, self.legend_))
        for _, _, a in sorted(items, key=lambda t: (t[0], t[1])):
            if isinstance(a, _Line):
                pts = self.to_display(np.stack([a.x, a.y], -1))
                if a.ls != "None":
                    _draw_line(canvas, pts, a.lw, a.rgb, dpi, a.ls,
                               clip=clip)
                if a.marker == ".":
                    _draw_points(canvas, pts, 6.0, a.rgb, dpi, clip=clip)
            elif isinstance(a, _Fill):
                dev = canvas.dev(self.to_display(a.verts))
                if a.edge:
                    # one path with a face and an edge: Collection.draw's
                    # single-path case draws it as a marker at (0, 0),
                    # half a pixel off unless the path snaps
                    snapped = _snap(dev, dpi / 72.0) is not dev
                    dev = _snap(dev, dpi / 72.0) if snapped else dev + 0.5
                canvas.fill([dev], a.rgb, a.alpha, clip=clip)
                if a.edge:
                    canvas.stroke([np.vstack([dev, dev[:1]])],
                                  dpi / 72.0, a.rgb, a.alpha, cap=0,
                                  join=1, clip=clip)
            elif isinstance(a, _Segments):
                for s in a.segs:
                    _draw_line(canvas, self.to_display(s), a.lw, a.rgb, dpi,
                               a.ls, clip=clip, solid_cap=0)
            elif isinstance(a, _Image):
                self._draw_image(canvas, a, box)
            elif isinstance(a, _CbarSolids):
                _draw_cbar(self, canvas)
            elif a == "spines":
                self._draw_spines(canvas)
            elif a == "axis":
                self._draw_axis(canvas)
            elif isinstance(a, (Text, _Legend)):
                a.draw(fig, canvas)

    def _draw_image(self, canvas, im, box):
        """AxesImage._make_image then draw_image: the output grid is the
        image's display box clipped to the axes, its size rounded up, each
        output pixel sampled at its centre (nearest) or averaged over the
        source pixels it covers (a downsampled image)."""
        ex = im.extent
        p0 = self.to_display([[ex[0], ex[2]]])[0]
        p1 = self.to_display([[ex[1], ex[3]]])[0]
        ox0, ox1 = sorted((p0[0], p1[0]))
        oy0, oy1 = sorted((p0[1], p1[1]))
        cx0, cy0 = max(ox0, box[0]), max(oy0, box[1])
        cx1, cy1 = min(ox1, box[2]), min(oy1, box[3])
        if cx1 <= cx0 or cy1 <= cy0:
            return
        wb, hb = cx1 - cx0, cy1 - cy0
        ow, oh = (math.ceil(wb), math.ceil(hb)) if (wb % 1 or hb % 1) else (
            int(wb), int(hb))
        sx, sy = ow / wb, oh / hb
        H, W = im.data.shape[:2]
        # output pixel centre -> source (column, row from the bottom)
        u = ((np.arange(ow) + 0.5) / sx + cx0 - ox0) / (ox1 - ox0) * W
        v = ((np.arange(oh) + 0.5) / sy + cy0 - oy0) / (oy1 - oy0) * H
        if im.interpolation == "nearest" or (W <= ow and H <= oh):
            ci = np.clip(np.floor(u).astype(int), 0, W - 1)
            ri = np.clip(np.floor(v).astype(int), 0, H - 1)
            rgb = im.rgb(im.data[ri][:, ci])
        else:
            rgb = _area_resample(im.rgb(im.data), u, v)
        # to_rgba(bytes=True): levels truncated
        canvas.image(np.floor(rgb[::-1] * 255.0), cx0, cy0,
                     canvas.clip_of(box))

    def _draw_spines(self, canvas):
        dpi = self.fig.dpi
        x0, y0 = self.axes_to_display(self.fig, 0.0, 0.0)
        x1, y1 = self.axes_to_display(self.fig, 1.0, 1.0)
        w = AXES_LINE_WIDTH
        if self.cbar is not None:
            pts = [(x0, y0), (x0, y1), (x1, y1), (x1, y0), (x0, y0)]
            dev = _snap(canvas.dev(pts), w * dpi / 72.0)
            canvas.stroke([dev], w * dpi / 72.0, np.zeros(3), cap=0, join=0)
            return
        for p, q in (((x0, y0), (x0, y1)), ((x1, y0), (x1, y1)),
                     ((x0, y0), (x1, y0)), ((x0, y1), (x1, y1))):
            _draw_line(canvas, np.array([p, q]), w, np.zeros(3), dpi)

    def _draw_axis(self, canvas):
        fig = self.fig
        dpi = fig.dpi
        x0, y0 = self.axes_to_display(fig, 0.0, 0.0)
        x1, y1 = self.axes_to_display(fig, 1.0, 1.0)
        L = TICK_SIZE * dpi / 72.0
        tw = TICK_WIDTH * dpi / 72.0
        sv = 0.5 if int(math.floor(tw + 0.5)) % 2 else 0.0
        Ls = math.floor(L + 0.5) + sv
        for a in ("x", "y"):
            if self.cbar is not None and a == "x":
                continue
            ticks, _, _ = self._drawn_ticks(a)
            for p, _ in ticks:
                if a == "x":
                    px = math.floor(p + 0.5)
                    py = math.floor(canvas.H - y0 + 0.5)
                    seg = [(px + sv, py + sv), (px + sv, py + Ls)]
                elif self.cbar is not None:
                    px = math.floor(x1 + 0.5)
                    py = math.floor(canvas.H - p + 0.5)
                    seg = [(px + sv, py + sv), (px + Ls, py + sv)]
                else:
                    px = math.floor(x0 + 0.5)
                    py = math.floor(canvas.H - p + 0.5)
                    seg = [(px + sv, py + sv), (px - Ls + 2 * sv, py + sv)]
                canvas.stroke([np.asarray(seg, np.float64)], tw,
                              np.zeros(3), cap=0, join=1)
            tl = self._tick_labels(a)
            for t in tl:
                t.draw(fig, canvas)
            self._offset_text(a, [t.window_extent(fig) for t in tl]).draw(
                fig, canvas)
        self.xlabel.draw(fig, canvas)
        self.ylabel.draw(fig, canvas)


def _area_resample(rgb, u, v):
    """Each output pixel the mean of the source pixels under it (the
    antialiasing filter of a downsampled image, approximated)."""
    H, W = rgb.shape[:2]
    du = (u[1] - u[0]) if len(u) > 1 else W
    dv = (v[1] - v[0]) if len(v) > 1 else H
    c0 = np.clip(np.floor(u - du / 2).astype(int), 0, W - 1)
    c1 = np.clip(np.ceil(u + du / 2).astype(int), 1, W)
    r0 = np.clip(np.floor(v - dv / 2).astype(int), 0, H - 1)
    r1 = np.clip(np.ceil(v + dv / 2).astype(int), 1, H)
    cs = np.pad(np.cumsum(np.cumsum(rgb, 0), 1), ((1, 0), (1, 0), (0, 0)))
    out = (cs[r1][:, c1] - cs[r0][:, c1] - cs[r1][:, c0] + cs[r0][:, c0])
    n = ((r1 - r0)[:, None] * (c1 - c0)[None, :])[..., None]
    return out / np.maximum(n, 1)


# ------------------------------------------------------------------ figure
class Figure:
    def __init__(self, figsize=(6.4, 4.8), dpi=100.0):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.subplotpars = dict(SUBPLOT)
        self.axes: List[Axes] = []
        self.texts: List[Text] = []
        self.suptitle_: Optional[Text] = None
        self._origin = (0.0, 0.0)

    def frac_to_display(self, fx, fy):
        w, h = self.figsize
        return (fx * (w * self.dpi) + self._origin[0],
                fy * (h * self.dpi) + self._origin[1])

    def add_gridspec(self, nrows, ncols, height_ratios=None,
                     width_ratios=None):
        return GridSpec(self, nrows, ncols, height_ratios, width_ratios)

    def add_subplot(self, spec: SubplotSpec) -> Axes:
        ax = Axes(self, spec)
        self.axes.append(ax)
        return ax

    def subplots(self, nrows=1, ncols=1):
        gs = self.add_gridspec(nrows, ncols)
        return np.array([[self.add_subplot(gs[r, c]) for c in range(ncols)]
                         for r in range(nrows)], dtype=object)

    def colorbar(self, im, ax: Axes):
        """make_axes_gridspec (location right, fraction 0.15, pad 0.05,
        aspect 20) and a colour bar of the image's table over its data
        range."""
        fraction, pad = 0.15, 0.05
        gs = GridSpec(self, 3, 2, height_ratios=[0.0, 1.0, 0.0],
                      width_ratios=[1 - fraction - pad, fraction],
                      wspace=2 * pad / (1 - pad), hspace=0.0,
                      parent=ax.spec)
        ax.spec = gs[:, 0]
        cax = Axes(self, gs[1, 1])
        cax.box_aspect = 20.0
        cax.cbar = im
        cax.lim["y"] = (im.vmin, im.vmax)
        cax.auto["y"] = False
        cax.lim["x"] = (0.0, 1.0)
        cax.auto["x"] = False
        cax.artists.append(_CbarSolids())
        self.axes.append(cax)
        return cax

    def suptitle(self, s, y=0.98):
        self.suptitle_ = Text(lambda f: f.frac_to_display(0.5, y), s,
                              "large", ha="center", va="top")

    def text(self, x, y, s, va="baseline", ha="left", rotation=0.0,
             fontsize=FONT_SIZE):
        self.texts.append(Text(lambda f: f.frac_to_display(x, y), s,
                               fontsize, ha=ha, va=va, rotation=rotation))

    # ---- layout
    def _groups(self):
        groups = {}
        for ax in self.axes:
            top = ax.spec.topmost()
            groups.setdefault(top.key(), (top, []))[1].append(ax)
        return list(groups.values())

    def tight_layout(self, pad=1.08):
        """Figure.tight_layout: _auto_adjust_subplotpars at this dpi."""
        groups = self._groups()
        rows = max(t.gs.nrows for t, _ in groups)
        cols = max(t.gs.ncols for t, _ in groups)
        vspaces = np.zeros((rows + 1, cols))
        hspaces = np.zeros((rows, cols + 1))
        fw, fh = self.figsize
        W, H = fw * self.dpi, fh * self.dpi
        # transFigure.inverted(), as numpy inverts the affine matrix
        inv = np.linalg.inv(np.array([[W, 0.0, 0.0], [0.0, H, 0.0],
                                      [0.0, 0.0, 1.0]]))
        for top, axs in groups:
            ax_bbox = top.position()
            if not any(a.visible for a in axs):
                continue
            tb = _union([a.tight_bbox(self) for a in axs if a.visible])
            p = np.array([[tb[0], tb[1]], [tb[2], tb[3]]])
            p = p @ inv[:2, :2].T + inv[:2, 2]
            tb = (p[0, 0], p[0, 1], p[1, 0], p[1, 1])
            rs, cs = top.rows, top.cols
            dr, dc = rows // top.gs.nrows, cols // top.gs.ncols
            rs = slice(rs[0] * dr, rs[1] * dr)
            cs = slice(cs[0] * dc, cs[1] * dc)
            hspaces[rs, cs.start] += ax_bbox[0] - tb[0]
            hspaces[rs, cs.stop] += tb[2] - ax_bbox[2]
            vspaces[rs.start, cs] += tb[3] - ax_bbox[3]
            vspaces[rs.stop, cs] += ax_bbox[1] - tb[1]
        pad_inch = pad * FONT_SIZE / 72
        ml = max(hspaces[:, 0].max(), 0) + pad_inch / fw
        mr = max(hspaces[:, -1].max(), 0) + pad_inch / fw
        mt = max(vspaces[0, :].max(), 0) + pad_inch / fh
        if self.suptitle_ is not None and self.suptitle_.s:
            b = self.suptitle_.window_extent(self)
            p = np.array([[b[0], b[1]], [b[2], b[3]]]) @ inv[:2, :2].T
            mt += (p[1, 1] - p[0, 1]) + pad_inch / fh
        mb = max(vspaces[-1, :].max(), 0) + pad_inch / fh
        if ml + mr >= 1 or mb + mt >= 1:
            return
        kw = dict(left=ml, right=1 - mr, bottom=mb, top=1 - mt)
        if cols > 1:
            hs = hspaces[:, 1:-1].max() + pad_inch / fw
            h_axes = (1 - mr - ml - hs * (cols - 1)) / cols
            if h_axes < 0:
                return
            kw["wspace"] = hs / h_axes
        if rows > 1:
            vs = vspaces[1:-1, :].max() + pad_inch / fh
            v_axes = (1 - mt - mb - vs * (rows - 1)) / rows
            if v_axes < 0:
                return
            kw["hspace"] = vs / v_axes
        self.subplotpars.update(kw)

    def tight_bbox(self):
        """Figure.get_tightbbox in display pixels."""
        bb = [t.window_extent(self) for t in self._fig_texts()]
        bb += [a.tight_bbox(self, for_layout_only=False)
               for a in self.axes if a.visible]
        bb = [b for b in bb if np.isfinite(_wh(b)).all()
              and (_wh(b)[0] != 0 or _wh(b)[1] != 0)]
        return _union(bb)

    def _fig_texts(self):
        return ([self.suptitle_] if self.suptitle_ is not None else []) + \
            self.texts

    # ---- output
    def render(self, dpi=None, bbox_inches=None) -> np.ndarray:
        """The figure as matplotlib's savefig draws it: uint8 RGBA."""
        old = self.dpi
        self.dpi = float(dpi or self.dpi)
        try:
            fw, fh = self.figsize
            W, H = fw * self.dpi, fh * self.dpi
            if bbox_inches == "tight":
                b = self.tight_bbox()
                pad = 0.1 * self.dpi
                b = (b[0] - pad, b[1] - pad, b[2] + pad, b[3] + pad)
                self._origin = (-b[0], -b[1])
                W, H = b[2] - b[0], b[3] - b[1]
            canvas = _Canvas(int(W), int(H), H)
            for ax in self.axes:
                if ax.visible:
                    ax.draw(canvas)
            for t in self._fig_texts():
                t.draw(self, canvas)
            return canvas.rgba8()
        finally:
            self.dpi = old
            self._origin = (0.0, 0.0)

    def savefig(self, path, dpi=None, bbox_inches=None):
        rgba = self.render(dpi, bbox_inches)
        image_io.write_png(path, rgba[..., [2, 1, 0, 3]])
        return path


class _CbarSolids:
    """The colour bar's 256 bands over (vmin, vmax): a QuadMesh, aliased."""

    zorder = 0.0


def _draw_cbar(ax: Axes, canvas):
    box = ax.bbox(ax.fig)
    x0, y0, x1, y1 = box
    c0, c1 = math.floor(x0 + 0.5), math.floor(x1 + 0.5)
    r_top, r_bot = math.floor(canvas.H - y1 + 0.5), math.floor(
        canvas.H - y0 + 0.5)
    rows = np.arange(r_top, r_bot)
    yc = canvas.H - (rows + 0.5)
    band = np.clip(np.floor((yc - y0) / (y1 - y0) * ax.cbar.table.shape[0]
                            ).astype(int), 0, ax.cbar.table.shape[0] - 1)
    rgb = ax.cbar.table[band] * 255.0
    canvas.img[r_top:r_bot, c0:c1] = rgb[:, None, :]


def figure(figsize=(6.4, 4.8)) -> Figure:
    return Figure(figsize)


def subplots(nrows=1, ncols=1, figsize=(6.4, 4.8), squeeze=True):
    """plt.subplots: (figure, axes array [nrows, ncols]); squeezed as
    matplotlib squeezes it (one Axes, or a 1-D array)."""
    fig = Figure(figsize)
    axs = fig.subplots(nrows, ncols)
    if squeeze:
        axs = axs.item() if axs.size == 1 else axs.squeeze()
    return fig, axs


def close(fig=None):
    """plt.close: nothing is held open."""
