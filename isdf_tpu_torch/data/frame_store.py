"""Host-side frame metadata store.

The device FrameBuffer (engine/buffer.py) owns everything the hot loop
needs; this store keeps the host copies of the ingested frames — the role
of the np fields in the reference's FrameData
(isdf/datasets/data_util.py:11-102), grow-only with replace-last-row
semantics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class FrameData:
    """One ingested frame (host copy)."""
    frame_id: int
    image: Optional[np.ndarray]      # [H, W, 3] uint8
    depth: np.ndarray                # [H, W] float32 (metres, 0 = invalid)
    T_WC: np.ndarray                 # [4, 4]
    normals: Optional[np.ndarray] = None   # [H, W, 3] or None
    T_WC_gt: Optional[np.ndarray] = None


class FrameStore:
    def __init__(self):
        self.frames: List[FrameData] = []

    def add(self, frame: FrameData, replace: bool = False):
        if replace and self.frames:
            self.frames[-1] = frame
        else:
            self.frames.append(frame)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> FrameData:
        return self.frames[i]

    @property
    def frame_ids(self) -> np.ndarray:
        return np.array([f.frame_id for f in self.frames], np.int64)

    def depth_batch_np(self) -> np.ndarray:
        return np.stack([f.depth for f in self.frames])

    def T_WC_batch_np(self) -> np.ndarray:
        return np.stack([f.T_WC for f in self.frames])

    def im_batch_np(self) -> np.ndarray:
        return np.stack([f.image for f in self.frames])
