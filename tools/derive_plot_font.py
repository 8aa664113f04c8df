#!/usr/bin/env python
"""Regenerate the glyph table of isdf_tpu_torch/vis/plot_font.py from
matplotlib's own FreeType wrapper.

    python -m tools.derive_plot_font          (from the repo's root; needs
                                               matplotlib 3.10)

matplotlib's Agg backend lays text out with ``FT2Font.set_text`` (hinting
``force_autohint``, ``text.hinting_factor`` 8) and measures it with
``get_width_height`` / ``get_descent``. For each face (DejaVu Sans, and
DejaVu Sans Oblique for italic titles) and each size of ``SIZES`` this
script records, per character of ``CHARS``: the pen advance and the glyph's
control box in 1/64 pixel, as ``set_text`` uses them, and the hinted outline
``get_path`` gives (moves, lines, conic curves, in 1/64 pixel); and the
non-zero kerning of every pair at that size. It then checks the port's
layout (``plot_font.text_extent``) against ``get_width_height`` /
``get_descent`` on random strings, and rewrites the table in plot_font.py
(the text between the two marker lines) as the base64 of a compressed
``.npz``. The DejaVu licence travels with the table, in the module's
header.
"""

from __future__ import annotations

import base64
import io
import os
import re
import textwrap

import numpy as np

FACES = {"normal": "DejaVuSans.ttf", "italic": "DejaVuSans-Oblique.ttf"}
# (face, points, dpi): every size a caller of vis/plot.py draws or measures
SIZES = ([("normal", pt, dpi) for pt in (7, 8, 9, 10, 12)
          for dpi in (100, 110, 120)]
         + [("italic", 12, dpi) for dpi in (100, 110, 120)])
HINTING_FACTOR = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(ROOT, "isdf_tpu_torch", "vis", "plot_font.py")


def _font(ft2font, mpl_dir, face):
    return ft2font.FT2Font(os.path.join(mpl_dir, "fonts", "ttf",
                                        FACES[face]),
                           HINTING_FACTOR, _kerning_factor=0)


def size_arrays(ft2font, flags, font, pt, dpi, chars):
    font.set_size(pt, dpi)
    idx = [font.get_char_index(ord(c)) for c in chars]
    adv, cbox, codes, verts, offs = [], [], [], [], [0]
    for c in chars:
        g = font.load_char(ord(c), flags=flags)
        cbox.append(g.bbox)
        v, k = font.get_path()
        v = np.rint(np.asarray(v) * 64).astype(np.int16)
        codes.append(np.asarray(k, np.uint8))
        verts.append(v)
        offs.append(offs[-1] + len(k))
        # the pen advance set_text uses: the second glyph's pen in "cc"
        # less the pair's kerning
        xys = font.set_text(c + c, 0, flags=flags)
        kern = font.get_kerning(idx[chars.index(c)], idx[chars.index(c)],
                                ft2font.Kerning.DEFAULT)
        adv.append(int(xys[1][0]) - kern)
    kern = []
    for i, a in enumerate(idx):
        for j, b in enumerate(idx):
            k = font.get_kerning(a, b, ft2font.Kerning.DEFAULT)
            if k:
                kern.append((i, j, k))
    return {"adv": np.asarray(adv, np.int32),
            "cbox": np.asarray(cbox, np.int32),
            "codes": np.concatenate(codes),
            "verts": np.concatenate(verts),
            "offs": np.asarray(offs, np.int32),
            "kern": np.asarray(kern, np.int32).reshape(-1, 3)}


def table(matplotlib, chars) -> bytes:
    from matplotlib import ft2font
    from matplotlib.backends.backend_agg import get_hinting_flag
    flags = get_hinting_flag()
    arrays = {}
    for face, pt, dpi in SIZES:
        font = _font(ft2font, matplotlib.get_data_path(), face)
        for k, v in size_arrays(ft2font, flags, font, pt, dpi,
                                chars).items():
            arrays[f"{face}_{pt}_{dpi}_{k}"] = v
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def check(matplotlib, plot_font, n: int = 400):
    """The port's extents equal get_width_height / get_descent."""
    from matplotlib import ft2font
    from matplotlib.backends.backend_agg import get_hinting_flag
    flags = get_hinting_flag()
    rng = np.random.default_rng(0)
    chars = list(plot_font.CHARS)
    for face, pt, dpi in SIZES:
        font = _font(ft2font, matplotlib.get_data_path(), face)
        font.set_size(pt, dpi)
        for _ in range(n):
            s = "".join(rng.choice(chars, rng.integers(1, 14)))
            font.set_text(s, 0, flags=flags)
            w, h = font.get_width_height()
            want = (w / 64, h / 64, font.get_descent() / 64)
            got = plot_font.text_extent(s, pt, dpi, face)
            assert got == want, (face, pt, dpi, s, got, want)


def main():
    import matplotlib
    from isdf_tpu_torch.vis import plot_font
    blob = base64.b64encode(table(matplotlib, plot_font.CHARS)).decode()
    with open(os.path.join(matplotlib.get_data_path(), "fonts", "ttf",
                           "LICENSE_DEJAVU")) as f:
        licence = f.read().rstrip()
    with open(TARGET) as f:
        src = f.read()
    body = ('# <table>\n_LICENSE_DEJAVU = """\n' + licence.replace(
        '"""', "'''") + '\n"""\n_TABLE = """\n'
        + "\n".join(textwrap.wrap(blob, 76)) + '\n"""\n# </table>')
    src = re.sub(r"# <table>.*# </table>", lambda _: body, src,
                 flags=re.S)
    with open(TARGET, "w") as f:
        f.write(src)
    plot_font._faces.cache_clear()
    import importlib
    importlib.reload(plot_font)
    check(matplotlib, plot_font)
    print(f"wrote {len(blob)} characters of table; extents checked")


if __name__ == "__main__":
    main()
