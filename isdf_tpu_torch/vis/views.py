"""2-D visual monitors (isdf_tpu/vis/views.py; reference trainer.py:1020-1150
latest_frame_vis / frames_vis, visualisation/draw.py).

Every function returns uint8 RGB images: the keyframe strip and the
latest frame's rgb and depth beside the depth and normals rendered
through the current net.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.vis.colormaps import turbo


def depth_to_rgb(depth: np.ndarray, max_depth: Optional[float] = None
                 ) -> np.ndarray:
    """Colourised depth through turbo (imgviz.depth2rgb stand-in); 0 is
    black."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    md = max_depth or (d[valid].max() if valid.any() else 1.0)
    dn = np.clip(d / max(md, 1e-6), 0, 1)
    img = (turbo(dn) * 255).astype(np.uint8)
    img[~valid] = 0
    return img


def keyframe_strip(trainer, reduce_factor: int = 6,
                   max_frames: int = 12) -> np.ndarray:
    """Horizontal strip of keyframe rgbs (reference draw.py:139-150)."""
    ims = []
    for f in trainer.frames.frames[-max_frames:]:
        im = f.image
        if im is None:
            im = depth_to_rgb(f.depth)
        small = im[::reduce_factor, ::reduce_factor]
        ims.append(small)
    if not ims:
        return np.zeros((8, 8, 3), np.uint8)
    h = min(i.shape[0] for i in ims)
    return np.concatenate([i[:h] for i in ims], axis=1)


def render_latest(trainer, reduce_factor: int = 8, n_strat: int = 40,
                  draws=None):
    """The latest frame's depth [H', W'] and camera-frame normals
    [H', W', 3] rendered through the current net at 1/reduce_factor
    resolution, and its GT depth there. The stratified draws come from a
    generator of the call's own, seeded 0 on the trainer's device (as
    isdf_tpu draws from PRNGKey(0)), never the trainer's, which CUDA
    graphs replay; ``draws`` [H' * W', n_strat] passes them in (tests)."""
    from isdf_tpu_torch.ops import geometry as G
    from isdf_tpu_torch.ops import render as R

    f = trainer.frames[-1]
    dev = trainer.device
    H, W = trainer.H // reduce_factor, trainer.W // reduce_factor
    depth_small = f.depth[::reduce_factor, ::reduce_factor][:H, :W]
    dirs = G.ray_dirs_C(H, W, trainer.fx / reduce_factor,
                        trainer.fy / reduce_factor,
                        trainer.cx / reduce_factor,
                        trainer.cy / reduce_factor, device=dev
                        ).reshape(1, -1, 3)
    depth_flat = torch.as_tensor(
        np.where(depth_small > 0, depth_small, 3.0).reshape(1, -1),
        dtype=torch.float32, device=dev)
    T = torch.as_tensor(f.T_WC, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rd = trainer.fns.render_depth(trainer.params, T[None], dirs, depth_flat,
                                  trainer.transform_dev, gen,
                                  n_strat=n_strat, draws=draws)

    def grad_fn(pc):
        return trainer.fns.eval_sdf_grad(
            trainer.params, pc.reshape(-1, 3),
            trainer.transform_dev).reshape(pc.shape)

    normals = R.render_normals_C(T[None, None], rd.reshape(-1), grad_fn,
                                 dirs.reshape(-1, 3))
    return (rd.reshape(H, W).cpu().numpy(),
            normals.detach().reshape(H, W, 3).cpu().numpy(), depth_small)


def latest_frame_vis(trainer, reduce_factor: int = 8,
                     n_strat: int = 40, draws=None) -> np.ndarray:
    """2x2 panel: frame rgb + GT depth over rendered normals + rendered
    depth (reference trainer.py:1055-1150)."""
    render_d, normals_C, depth_small = render_latest(
        trainer, reduce_factor, n_strat, draws)
    H, W = render_d.shape
    normals_img = ((normals_C + 1) * 127.5).astype(np.uint8)
    f = trainer.frames[-1]
    rgb = (f.image[::reduce_factor, ::reduce_factor][:H, :W]
           if f.image is not None else depth_to_rgb(depth_small))
    md = float(max(depth_small.max(), render_d.max(), 1e-3))
    top = np.concatenate([rgb, depth_to_rgb(depth_small, md)], axis=1)
    bottom = np.concatenate([normals_img, depth_to_rgb(render_d, md)],
                            axis=1)
    return np.concatenate([top, bottom], axis=0)


def save_view(img: np.ndarray, path: str):
    IO.imwrite(path, img[..., ::-1])
