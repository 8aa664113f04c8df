"""The training cells' set-up and their comparison with the reference.

``build`` makes one scene: the room of a seed, its views rendered on the
card, a Trainer of the configuration over them with the benchmark's
weights, and its arena filled with every view as a keyframe. The views,
poses and weights stay with the benchmark, so that the reference can
start from the same inputs. ``first_steps`` drives the trainer's first
steps through the window's own call and records what the comparison reads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import numpy as np
import torch

from benchmark import inputs as I
from benchmark import reference as REF


class Views:
    """The benchmark's views as a dataset the Trainer reads: {"depth",
    "T"} per index, the camera, and the room's bounds."""

    def __init__(self, depth: np.ndarray, poses: np.ndarray, cam: dict,
                 room: I.Room):
        self.depth, self.poses, self.cam, self.room = depth, poses, cam, room

    def __len__(self):
        return self.depth.shape[0]

    def camera(self):
        return dict(self.cam)

    def scene_bounds(self):
        return self.room.bounds_transform(), self.room.extents.copy()

    def __getitem__(self, i):
        return {"depth": self.depth[int(i)], "T": self.poses[int(i)],
                "image": None}


@dataclasses.dataclass
class Scene:
    trainer: object
    room: I.Room
    cam: dict
    depth: np.ndarray        # [C, H, W] float32, the arena's views in order
    poses: np.ndarray        # [C, 4, 4] float32
    layers: list             # the initial weights [(w, b)] on the device
    seed: int


def camera(params) -> dict:
    """The cell's camera: the shipped 1200 x 680, or a rehearsal's
    smaller one at the same field of view."""
    H, W = int(params.get("H", I.CAM["H"])), int(params.get("W", I.CAM["W"]))
    f = I.CAM["fx"] * W / I.CAM["W"]
    return dict(H=H, W=W, fx=f, fy=f, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)


def build(ctx, seed: int, cfg_dict: dict) -> Scene:
    """A trainer over a seed's room with a full arena of its views."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import fused_adamw
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.utils.config import config_from_dict

    from isdf_tpu_torch.utils import nvcc

    t = [time.perf_counter()]
    cfg = config_from_dict(cfg_dict)
    dev = ctx.device
    cam = camera(ctx.params)
    C = cfg.kf_buffer_size
    room = I.Room(seed)
    poses = room.poses(C)
    dirs = I.ray_dirs_C(cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
                        cam["cy"], dev)
    depth = room.render(torch.as_tensor(poses, device=dev), dirs,
                        cfg.max_depth).cpu().numpy()
    t.append(time.perf_counter())
    tr = Trainer(cfg, dataset=Views(depth, poses, cam, room), seed=seed,
                 device=dev)
    t.append(time.perf_counter())
    mp = REF.Map(cfg_dict)
    layers = I.make_weights(seed, mp.E, mp.H, mp.blocks, dev)
    tr.params = M.params_from_jax(I.as_tree(layers, mp.blocks), tr.model,
                                  device=dev)
    tr.frozen_params = M.copy_params(tr.params)
    tr.opt_state = fused_adamw.init_state(tr.params)
    for i in range(C):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([i])[0])
    t.append(time.perf_counter())
    built = sum(v["build_s"] for v in nvcc.BUILD_INFO.values())
    ctx.note(f"set-up: views rendered {t[1] - t[0]:.3f} s, Trainer "
             f"{t[2] - t[1]:.3f} s (nvcc builds {built:.3f} s), arena "
             f"filled {t[3] - t[2]:.3f} s")
    return Scene(tr, room, cam, depth, poses, layers, seed)


def unpack(planes, mp: REF.Map) -> List[tuple]:
    """Per-layer (w [fan_in, fan_out], b [fan_out]) of the program's packed
    planes (Wp [L, 2K, H]: layer l's weight at rows 0:fan_in, the skip
    layer's pe rows at K:K+E; bp [L, H]), copied."""
    Wp, bp = planes["Wp"], planes["bp"]
    H, E = mp.H, mp.E
    K = (max(H, E) + 15) // 16 * 16
    out = []
    for l, (fi, fo) in enumerate(I.layer_shapes(E, H, mp.blocks)):
        if l == mp.blocks + 1:
            w = torch.cat([Wp[l, :H, :fo], Wp[l, K:K + fi - H, :fo]])
        else:
            w = Wp[l, :fi, :fo]
        out.append((w.clone(), bp[l, :fo].clone()))
    return out


@dataclasses.dataclass
class FirstSteps:
    losses: List[float]      # each step's total loss
    grad0: list              # the first step's gradient, per layer
    delta: list              # the parameters' change over the steps
    prio1: tuple = None      # the arena's priorities after step 1


# what a step changes on the host besides its tensors: the sim clock and
# the step counters (Trainer._bill)
_BOOKS = ("steps_taken", "steps_since_frame", "tot_step_time", "measured_s")


def stepped_tensors(t) -> list:
    """The tensors a step updates in place: parameters, optimiser state
    and the arena's priority rows."""
    return ([t.params[k] for k in sorted(t.params)] + [t.opt_state["count"]]
            + [t.opt_state[m][k] for m in ("mu", "nu")
               for k in sorted(t.opt_state[m])]
            + [t.buffer.frame_avg_loss, t.buffer.loss_approx])


def snapshot(t):
    """A copy of what a step changes, for ``restore``."""
    return ([x.clone() for x in stepped_tensors(t)],
            {k: getattr(t, k) for k in _BOOKS})


def restore(t, snap):
    """Copy a snapshot back into the same tensors (a captured step graph
    reads them at fixed addresses) and set the books back."""
    for x, y in zip(stepped_tensors(t), snap[0]):
        x.copy_(y)
    for k, v in snap[1].items():
        setattr(t, k, v)


def first_steps(run: Callable[[int], List[List[float]]], trainers,
                mp: REF.Map) -> List[FirstSteps]:
    """Three steps of each trainer through ``run`` (the window's own call:
    ``run(n)`` steps every scene n times and returns each scene's losses):
    one, then two. A step is run first and undone, so that the step's
    graph key is captured and the compared steps are replays of the graph
    the window replays (a key's first call runs eagerly). The first step's
    gradient is read back from the optimiser's first moment (m = (1 - b1) g
    after one step), the change from the parameters before step 4."""
    snaps = [snapshot(t) for t in trainers]
    run(1)
    for t, sn in zip(trainers, snaps):
        restore(t, sn)
    p0 = [unpack(t.params, mp) for t in trainers]
    losses = run(1)
    g0 = [[(w / 0.1, b / 0.1) for w, b in unpack(t.opt_state["mu"], mp)]
          for t in trainers]
    prio = [(t.buffer.frame_avg_loss.clone(), t.buffer.loss_approx.clone())
            for t in trainers]
    losses = [a + b for a, b in zip(losses, run(2))]
    out = []
    for t, a, g, l, pr in zip(trainers, p0, g0, losses, prio):
        p3 = unpack(t.params, mp)
        delta = [(w3 - w0, b3 - b0) for (w3, b3), (w0, b0) in zip(p3, a)]
        out.append(FirstSteps(l, g, delta, pr))
    return out


def stated_precision(cfg_dict: dict) -> str:
    """The hidden products' precision the configuration states: bf16
    operands for ``mm_precision: default``, else float32."""
    mm = cfg_dict.get("tpu", {}).get("mm_precision", "default")
    return "bf16" if mm == "default" else "f32"


def compare(ctx, scene: Scene, cfg_dict: dict, fs: FirstSteps) -> dict:
    """The reference's first steps from the scene's inputs, at the stated
    precision, against the readings ``fs`` (the program's, or those of the
    reference in its place)."""
    ref = _ref(ctx, scene, cfg_dict, stated_precision(cfg_dict), False)
    return REF.compare_first_steps(ref, fs.losses, fs.grad0, fs.delta)


def _ref(ctx, scene: Scene, cfg_dict: dict, prec: str,
         half_batch: bool) -> REF.RefStep:
    dev = ctx.device
    return REF.RefStep(
        cfg_dict, scene.layers, torch.as_tensor(scene.depth, device=dev),
        torch.as_tensor(scene.poses, device=dev), scene.cam,
        torch.as_tensor(np.linalg.inv(scene.room.bounds_transform())
                        .astype(np.float32), device=dev),
        scene.seed, prec=prec, half_batch=half_batch)


def ref_first_steps(ctx, scene: Scene, cfg_dict: dict, prec: str,
                    half_batch: bool = False) -> FirstSteps:
    """The readings of the reference put in the program's place: at
    ``prec`` (the control: "fp8"), or with half of each batch left out."""
    return readings(_ref(ctx, scene, cfg_dict, prec, half_batch))


def readings(ref: REF.RefStep) -> FirstSteps:
    """A reference's own first three steps, read as the program's are."""
    start = [(w.clone(), b.clone()) for w, b in ref.layers]
    _, _, g0, _ = ref.grads_of(0)
    losses = [ref.step(t) for t in range(3)]
    delta = [(w1 - w0, b1 - b0) for (w1, b1), (w0, b0)
             in zip(ref.layers, start)]
    return FirstSteps(losses, g0, delta)
