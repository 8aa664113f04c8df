"""Dataset construction from a config (isdf_tpu/data/datasets.py). Only the
synthetic branch is ported; the other formats raise."""

from __future__ import annotations

import numpy as np

from isdf_tpu_torch.utils.config import Config


def make_dataset(config: Config, device="cpu"):
    if config.dataset_format != "synthetic":
        raise NotImplementedError(
            f"dataset format {config.dataset_format!r} is not ported yet; "
            "only 'synthetic' is")
    if config.pose_noise_std > 0:
        raise NotImplementedError("synthetic pose noise is not ported yet")
    from isdf_tpu_torch.data.synthetic import (SCENE_PRESETS,
                                               SyntheticDataset, make_scene)
    preset = "room_a"
    if config.seq_dir:
        name = [x for x in config.seq_dir.split("/") if x][-1]
        if name in SCENE_PRESETS:
            preset = name
    cam = config.camera
    return SyntheticDataset(
        make_scene(preset), n_frames=400, H=cam.h, W=cam.w,
        hfov_deg=float(2 * np.degrees(np.arctan(cam.w / (2 * cam.fx)))),
        max_depth=config.max_depth, device=device)
