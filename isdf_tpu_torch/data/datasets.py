"""Dataset construction from a config, and the eval-time frame cache
(isdf_tpu/data/datasets.py). Only the synthetic format is ported; the other
formats raise."""

from __future__ import annotations

import numpy as np

from isdf_tpu_torch.utils.config import Config


class SceneCache:
    """Eagerly cache every ``skip``-th frame for eval-time visible-region
    sampling (reference dataset.py:176-269 + eval_pts.py:421-424)."""

    def __init__(self, dataset, skip: int = 5):
        self.dataset = dataset
        self.skip = skip
        self._cache = {}

    def __len__(self):
        return len(self.dataset)

    def _frame(self, i):
        i = (int(i) // self.skip) * self.skip
        i = min(i, len(self.dataset) - 1)
        if i not in self._cache:
            s = self.dataset[i]
            self._cache[i] = (s["depth"], s["T"])
        return self._cache[i]

    def __getitem__(self, idxs):
        idxs = np.atleast_1d(np.asarray(idxs))
        # the cached frames covering the requested range, each once
        keys = sorted({(int(i) // self.skip) * self.skip for i in idxs})
        keys = [min(k, len(self.dataset) - 1) for k in keys]
        depths, Ts = zip(*[self._frame(k) for k in keys]) if keys else ((), ())
        return {"depth": np.stack(depths) if depths else np.zeros((0, 1, 1)),
                "T": np.stack(Ts) if Ts else np.zeros((0, 4, 4))}

    def get_all(self):
        return self[np.arange(0, len(self.dataset), self.skip)]


def make_dataset(config: Config, device="cpu"):
    if config.dataset_format != "synthetic":
        raise NotImplementedError(
            f"dataset format {config.dataset_format!r} is not ported yet; "
            "only 'synthetic' is")
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
        max_depth=config.max_depth, pose_noise_std=config.pose_noise_std,
        pose_noise_mode=config.pose_noise_mode, device=device)
