"""Fixed-capacity keyframe arena on the device (isdf_tpu/engine/buffer.py
in torch).

A static set of tensors with a fill count; "append or replace last" writes
a computed row, and all step-time access is by gather. Unlike the JAX
package the fill count is a host integer: the step branches on it without
a device sync (engine/step.py passes its value to the device in the step's
scalar table). Rows are updated in place, evictions too, so the arena's
tensors keep their storage for the life of the buffer: a captured step
(engine/step.py) reads them by address.
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


def reset(buf: FrameBuffer) -> FrameBuffer:
    """Empty the arena in place, as make_buffer leaves a new one: the
    tensors keep their storage, so a captured step reads the emptied rows
    (a new arena would be a second one in memory until the graphs drop
    the first)."""
    for a in (buf.depth, buf.T_WC, buf.normals, buf.frame_avg_loss,
              buf.loss_approx):
        if a is not None:
            a.zero_()
    buf.frame_id.fill_(-1)
    buf.count = 0
    return buf


# rows moved at a time by an eviction (a normals row of a 1200x680 frame
# is 9.8 MB)
_EVICT_CHUNK = 16


def evict_lowest_priority(buf: FrameBuffer,
                          keep_recent: int = 2) -> FrameBuffer:
    """Drop the older keyframe with the lowest running average loss (the
    replay window's own signal), compacting in order; the ``keep_recent``
    newest frames are never evicted. In place: the rows after the victim
    move up one, the last row stays as it was with frame id -1 (isdf_tpu's
    permutation gathers the last row onto itself). Reads the victim's
    index on the host."""
    C = buf.capacity
    idx = torch.arange(C, device=buf.depth.device)
    pool = idx < (buf.count - keep_recent)
    prio = torch.where(pool, buf.frame_avg_loss, torch.inf)
    victim = int(prio.argmin())
    planes = [buf.depth, buf.T_WC, buf.normals, buf.frame_avg_loss,
              buf.loss_approx, buf.frame_id]
    for a in planes:
        if a is None:
            continue
        # chunk [r, e) takes rows [r + 1, e + 1): every source row is read
        # before a later chunk overwrites it
        for r in range(victim, C - 1, _EVICT_CHUNK):
            e = min(r + _EVICT_CHUNK, C - 1)
            a[r:e] = a[r + 1:e + 1].clone()
    buf.frame_id[C - 1] = -1
    buf.count -= 1
    return buf


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
