"""Fixed-capacity keyframe arena on the device (isdf_tpu/engine/buffer.py
in torch).

A static set of tensors with a fill count; "append or replace last" writes
a computed row, and all step-time access is by gather. Unlike the JAX
package the fill count is a host integer: the eager step branches on it
without a device sync. Rows are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class FrameBuffer:
    depth: torch.Tensor               # [C, H, W]
    T_WC: torch.Tensor                # [C, 4, 4]
    normals: Optional[torch.Tensor]   # [C, H, W, 3] or None
    frame_avg_loss: torch.Tensor      # [C]
    loss_approx: torch.Tensor         # [C, f, f] block-pooled loss image
    frame_id: torch.Tensor            # [C] int32
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.depth.shape[0]


def make_buffer(capacity: int, H: int, W: int, with_normals: bool = True,
                factor: int = 8, device="cpu") -> FrameBuffer:
    z = dict(dtype=torch.float32, device=device)
    return FrameBuffer(
        depth=torch.zeros((capacity, H, W), **z),
        T_WC=torch.zeros((capacity, 4, 4), **z),
        normals=(torch.zeros((capacity, H, W, 3), **z)
                 if with_normals else None),
        frame_avg_loss=torch.zeros((capacity,), **z),
        loss_approx=torch.zeros((capacity, factor, factor), **z),
        frame_id=torch.full((capacity,), -1, dtype=torch.int32,
                            device=device),
        count=0)


def evict_lowest_priority(buf: FrameBuffer,
                          keep_recent: int = 2) -> FrameBuffer:
    """Drop the older keyframe with the lowest running average loss (the
    replay window's own signal), compacting in order; the ``keep_recent``
    newest frames are never evicted."""
    C = buf.capacity
    dev = buf.depth.device
    idx = torch.arange(C, device=dev)
    pool = idx < (buf.count - keep_recent)
    prio = torch.where(pool, buf.frame_avg_loss, torch.inf)
    victim = prio.argmin()
    perm = torch.where(idx < victim, idx, torch.clamp(idx + 1, max=C - 1))
    fid = buf.frame_id[perm]
    fid[C - 1] = -1
    return FrameBuffer(
        depth=buf.depth[perm], T_WC=buf.T_WC[perm],
        normals=None if buf.normals is None else buf.normals[perm],
        frame_avg_loss=buf.frame_avg_loss[perm],
        loss_approx=buf.loss_approx[perm], frame_id=fid,
        count=buf.count - 1)


def add_frame(buf: FrameBuffer, depth, T_WC, normals, frame_id: int,
              replace: bool) -> FrameBuffer:
    """Append a frame, or overwrite the newest row if ``replace``
    (reference add_data, trainer.py:564-572). Writing past capacity clamps
    to the last row (callers evict first)."""
    row = buf.count - 1 if replace else buf.count
    row = min(max(row, 0), buf.capacity - 1)
    buf.depth[row] = depth
    buf.T_WC[row] = T_WC
    if buf.normals is not None:
        buf.normals[row] = normals
    buf.frame_avg_loss[row] = 0.0
    buf.loss_approx[row] = 0.0
    buf.frame_id[row] = int(frame_id)
    buf.count = min(buf.count if replace else buf.count + 1, buf.capacity)
    return buf
