#!/usr/bin/env python
"""Regenerate the glyph table of isdf_tpu_torch/vis/text.py from cv2.

    python -m tools.derive_glyphs          (from the repo's root; needs cv2)

cv2 5 draws FONT_HERSHEY_SIMPLEX with a built-in outline face: each glyph
is a coverage mask placed at an integer pen position, the pen advancing by
a whole number of pixels a character, and a string's masks are combined
over one another before the colour is blended (LINE_AA) or every covered
pixel is set (LINE_8). So a glyph's coverage at a scale, its offset from
the text origin and its advance describe the text exactly. This script
renders each printable ASCII character alone at each scale of SCALES,
white on black with LINE_AA (the pixel value is then the coverage), and
prints the table as the base64 of a zlib stream: per scale, per
character from ' ' to '~', the int16 fields advance, x0, y0 (offset of
the mask's top-left from the origin), w, h, then w * h coverage bytes.
"""

from __future__ import annotations

import base64
import struct
import textwrap
import zlib

import numpy as np

SCALES = (0.4, 0.45)
ORG = (40, 60)


def glyph(cv2, ch: str, scale: float):
    im = np.zeros((120, 160, 3), np.uint8)
    cv2.putText(im, ch, ORG, cv2.FONT_HERSHEY_SIMPLEX, scale,
                (255, 255, 255), 1, cv2.LINE_AA)
    a = im[..., 0]
    f = cv2.FONT_HERSHEY_SIMPLEX
    adv = (cv2.getTextSize(ch * 2, f, scale, 1)[0][0]
           - cv2.getTextSize(ch, f, scale, 1)[0][0])
    ys, xs = np.nonzero(a)
    if len(ys) == 0:
        return adv, 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return adv, x0 - ORG[0], y0 - ORG[1], a[y0:y1, x0:x1]


def table(cv2) -> bytes:
    out = []
    for scale in SCALES:
        for c in range(32, 127):
            adv, dx, dy, m = glyph(cv2, chr(c), scale)
            out.append(struct.pack("<5h", adv, dx, dy, m.shape[1],
                                   m.shape[0]))
            out.append(m.tobytes())
    return b"".join(out)


def main():
    import cv2
    blob = base64.b64encode(zlib.compress(table(cv2), 9)).decode()
    print(f"SCALES = {SCALES!r}")
    print('_GLYPHS = """')
    print("\n".join(textwrap.wrap(blob, 76)))
    print('"""')


if __name__ == "__main__":
    main()
