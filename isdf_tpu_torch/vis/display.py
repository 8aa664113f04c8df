"""Tiled multi-scene display (isdf_tpu/vis/display.py; the reference's
pyglet display_scenes, isdf/visualisation/display.py:42-236) rendered
headless into tiled PNG frames.

Pass a dict for one frame, a generator for a sequence. Scene values per
named tile:
  * np.ndarray [H, W, 3] uint8: an image, blitted as it is;
  * ("mesh", verts [N, 3], faces [M, 3]): the shaded mesh render;
  * ("points", pts [N, 3], cols [N, 3] | None): the point render;
  * a callable () -> one of the above, evaluated per frame.
A "__clear__" key is popped and ignored (reference display.py:68). Tiles
are resized with cv2's INTER_AREA rule (utils/image_io.py::resize_area)
and labelled with cv2's text (vis/text.py).
"""

from __future__ import annotations

import math
import os
import types
from typing import Dict, Optional, Tuple

import numpy as np

from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.vis.text import put_text


def get_tile_shape(num: int, hw_ratio: float = 1.0) -> Tuple[int, int]:
    """Rows/cols for ``num`` tiles (reference display.py:32-39)."""
    r_num = int(round(math.sqrt(num / hw_ratio)))
    c_num = 0
    while r_num * c_num < num:
        c_num += 1
    while (r_num - 1) * c_num >= num:
        r_num -= 1
    return r_num, c_num


def _render_item(item, height: int, width: int) -> np.ndarray:
    from isdf_tpu_torch.vis.viewer import (render_mesh_image,
                                           render_pointcloud_image)

    if callable(item):
        item = item()
    if isinstance(item, np.ndarray):
        img = item
    elif isinstance(item, (tuple, list)) and item and item[0] == "mesh":
        _, verts, faces = item
        img = render_mesh_image(np.asarray(verts), np.asarray(faces),
                                size=max(height, width))
    elif isinstance(item, (tuple, list)) and item and item[0] == "points":
        pts = np.asarray(item[1])
        cols = (np.asarray(item[2])
                if len(item) > 2 and item[2] is not None
                else np.full((len(pts), 3), 0.6))
        img = render_pointcloud_image(pts, cols, size=max(height, width))
    else:
        raise TypeError(f"unsupported scene item {type(item)!r}")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return IO.resize_area(np.ascontiguousarray(img[..., :3]),
                          (width, height))


def compose_tiles(scenes: Dict, height: int = 240, width: int = 320,
                  tile: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """One tiled frame [nrow*(height+label), ncol*width, 3] with the
    scene names drawn as the reference's label widgets."""
    scenes = dict(scenes)
    scenes.pop("__clear__", None)
    if tile is None:
        nrow, ncol = get_tile_shape(len(scenes), hw_ratio=height / width)
    else:
        nrow, ncol = tile
    label_h = 19
    out = np.full((nrow * (height + label_h), ncol * width, 3), 30,
                  np.uint8)
    for i, (name, item) in enumerate(scenes.items()):
        r, c = divmod(i, ncol)
        y0 = r * (height + label_h)
        x0 = c * width
        put_text(out, str(name), (x0 + 4, y0 + 14), 0.4, (230, 230, 230))
        out[y0 + label_h:y0 + label_h + height, x0:x0 + width] = \
            _render_item(item, height, width)
    return out


def display_scenes(data, height: int = 240, width: int = 320,
                   tile: Optional[Tuple[int, int]] = None,
                   caption: Optional[str] = None,
                   out_dir: str = "display_scenes",
                   max_frames: int = 10 ** 9):
    """Headless equivalent of the reference entry point: a dict renders
    one frame, a generator a frame per yield (up to max_frames) into
    <out_dir>/frame%05d.png. Returns the list of written paths."""
    os.makedirs(out_dir, exist_ok=True)
    if not isinstance(data, types.GeneratorType):
        data = iter([data])
    paths = []
    for i, scenes in enumerate(data):
        if i >= max_frames:
            break
        frame = compose_tiles(scenes, height=height, width=width,
                              tile=tile)
        if caption:
            put_text(frame, caption, (4, frame.shape[0] - 6), 0.4,
                     (180, 180, 255))
        p = os.path.join(out_dir, f"frame{i:05d}.png")
        IO.imwrite(p, frame[..., ::-1])
        paths.append(p)
    return paths
