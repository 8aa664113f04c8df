"""Device meshes: data parallelism over the ray batch, and the scene axis
of the multi-scene stepper's fleet mode (isdf_tpu/parallel/mesh.py).

isdf_tpu is single-controller: one process holds a ``jax.sharding.Mesh``,
shards the rays of a step over its "dp" axis after every random draw,
replicates the parameters, optimiser state and arena, and sums the fused
op's per-shard results with ``psum``. The port keeps that model in one
process, without torch.distributed: a mesh is an ordered tuple of shard
devices and an axis name, each shard's work is launched on its device
from the one controlling thread, and the sums run on the mesh's first
device in a fixed order.

A device may repeat in a mesh: that is how the CPU runs N shards (torch
has one CPU device, where isdf_tpu's tests have eight virtual ones) and how
one card runs 2 or 4. Replication makes one copy per distinct device,
never one per shard, so shards that share a card share its tensors.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch


class Mesh:
    """An ordered tuple of shard devices along one named axis ("dp" or
    "scene")."""

    def __init__(self, devices: Sequence, axis: str = "dp"):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> List[torch.device]:
        """The devices in order of first appearance, each once."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the card it names, so that equal devices compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_devices`` cards (all of them by default), or
    ``devices`` as given, repeats allowed."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices given for a mesh of "
                             f"{n_devices}")
        return Mesh(devices, axis)
    n_av = torch.cuda.device_count()
    n = n_av if n_devices is None else n_devices
    if n_av < n:
        raise RuntimeError(f"a mesh of {n} devices but only {n_av} "
                           "device(s) visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def parse_devices(text: Optional[str]):
    """A CLI's device argument: None, one device ("cuda", "cpu"), or a
    comma-separated list of them (a mesh, repeats allowed)."""
    if text is None or "," not in text:
        return text
    return [d.strip() for d in text.split(",") if d.strip()]


def block_devices(mesh: Mesh, k: int) -> List[torch.device]:
    """The device of each of ``k`` scenes on a "scene" mesh: scene j in
    block j // (k / D), as isdf_tpu's P("scene") places it."""
    if k % mesh.size:
        raise ValueError(f"{k} scenes do not divide the mesh's "
                         f"{mesh.size}-device scene axis")
    return [mesh.devices[j // (k // mesh.size)] for j in range(k)]


def split(mesh: Mesh, *arrays) -> List[tuple]:
    """Each array's leading axis cut into the mesh's equal contiguous
    shards, shard k on device k: one tuple of slices per shard (the
    counterpart of ray_sharding's P("dp") and constrain_rays). A slice on
    its own device is a view, so one shard copies nothing."""
    n = arrays[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide into {mesh.size} shards")
    k = n // mesh.size
    return [tuple(a[i * k:(i + 1) * k].to(d) for a in arrays)
            for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, x) -> Dict[torch.device, object]:
    """{device: x there} for each distinct device: x itself on the one it
    lies on, one copy on each other (none on a one-shard mesh). ``x``: a
    tensor or a dict of them."""
    def to(d):
        if isinstance(x, dict):
            return {k: v.to(d) for k, v in x.items()}
        return x.to(d)
    return {d: to(d) for d in mesh.distinct}


def fixed_sum(mesh: Mesh, parts):
    """The sum of per-shard tensors on the mesh's first device, added in
    shard order 0, 1, ..., N-1 (the counterpart of psum): no atomics, so
    two runs give the same bits. One shard's part is returned itself."""
    acc = parts[0].to(mesh.first)
    for p in parts[1:]:
        acc = acc + p.to(mesh.first)
    return acc


def gather(mesh: Mesh, parts):
    """Per-shard tensors joined along their leading axis in shard order on
    the mesh's first device (the counterpart of out_specs P("dp")). One
    shard's part is returned itself: ``torch.cat`` of one tensor copies
    it, which would add a kernel to every step of a one-shard mesh."""
    if len(parts) == 1:
        return parts[0].to(mesh.first)
    return torch.cat([p.to(mesh.first) for p in parts])


def on(device: torch.device):
    """A context that makes ``device`` current where it is a card (the
    kernels launch on the current stream of the current device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
