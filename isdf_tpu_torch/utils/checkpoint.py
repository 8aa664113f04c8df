"""Checkpoint and resume (isdf_tpu/utils/checkpoint.py).

A checkpoint is the whole training state: parameters, optimiser state, the
keyframe arena, the frozen net, the simulated clock and the scene frame, so
a restored run continues. The reference saves weights and restores weights
only (train/train.py:207-219, trainer.py:441-444).

Format: isdf_tpu's, one .npz archive of flattened leaves in isdf_tpu's
pytree order (dict keys sorted, lists in order) plus a JSON ``__meta__``
entry, so an archive written by either package loads in the other:

* ``params/i``, ``frozen/i``: the layer pytree of models/sdf_mlp.py::
  params_to_jax (cat, in, mid1.., mid2.., out, each {b, w}; B first with
  the Gaussian embedding);
* ``opt/i``: optax.adamw's state, (count, mu, nu) with mu and nu in the
  same pytree layout. Another layout (isdf_tpu's fused train op on a TPU
  keeps its moments on packed planes) restores the weights and
  re-initialises the moments, with ``opt_state_reinitialised`` in the
  returned meta, as isdf_tpu does;
* ``buf/i``: FrameBuffer's fields in order (depth, T_WC, normals when
  the config keeps them, frame_avg_loss, loss_approx, frame_id, count);
* ``torch/kf_gen``: the state of the port's keyframe-check generator
  (isdf_tpu ignores it).

RNG across packages: isdf_tpu draws a step from fold_in(bundle_key, step)
(threefry); the port from step_seed(seed, step) (engine/step.py). The port
writes its bundle seed as ``torch_bundle_seed`` and, as ``bundle_key``, the
same 64 bits as two uint32 words, which isdf_tpu parses as a threefry key.
A run resumed in the package that wrote the archive replays its own draws;
a run resumed across packages cannot replay the other package's draws, the
same hazard as comparing the two packages' runs at all. A port archive read
without ``torch_bundle_seed`` keeps the trainer's own seed.

Reference compatibility: ``load_reference_state_dict`` maps a torch
SDFMap.state_dict() onto the port's parameters and
``save_reference_checkpoint`` writes one (torch.save/torch.load are
native here).
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from isdf_tpu_torch.data.frame_store import FrameData, FrameStore
from isdf_tpu_torch.engine.buffer import FrameBuffer
from isdf_tpu_torch.models import fused_adamw
from isdf_tpu_torch.models import sdf_mlp as M

# SDFModel fields stored in the meta, isdf_tpu's SDFModel keywords
MODEL_KEYS = ("embedding_size", "hidden_size", "hidden_layers_block",
              "scale_output", "scale_input", "min_deg", "max_deg",
              "gauss_embed", "gauss_embed_std", "compute_dtype",
              "mm_precision")


def tree_leaves(tree):
    """Leaves of a nest of dicts, lists and tuples in JAX's flatten order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves):
    """Inverse of tree_leaves onto ``template``'s structure."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(x) for x in t)
        return next(it)

    return go(template)


def model_meta(model: M.SDFModel) -> Dict[str, Any]:
    """The model description isdf_tpu stores (its SDFModel keywords, the
    compute dtype as "bfloat16" or "float32")."""
    return {k: getattr(model, k) for k in MODEL_KEYS}


def model_from_meta(desc: Dict[str, Any]) -> M.SDFModel:
    """SDFModel from a stored description; an archive without a compute
    dtype computes in float32, as isdf_tpu reads it."""
    d = {k: v for k, v in desc.items() if k in MODEL_KEYS}
    d["compute_dtype"] = ("bfloat16" if d.get("compute_dtype") == "bfloat16"
                          else "float32")
    return M.SDFModel(**d)


def read_meta(z) -> Dict[str, Any]:
    return json.loads(bytes(z["__meta__"].tobytes()).decode())


def _buffer_leaves(buf: FrameBuffer):
    out = [buf.depth, buf.T_WC]
    if buf.normals is not None:
        out.append(buf.normals)
    return out + [buf.frame_avg_loss, buf.loss_approx, buf.frame_id,
                  np.asarray(buf.count, np.int32)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, trainer, step: int = 0):
    m = trainer.model
    seed = int(trainer._bundle_seed)
    meta: Dict[str, Any] = {
        "step": int(step),
        "tot_step_time": float(trainer.tot_step_time),
        "steps_since_frame": int(trainer.steps_since_frame),
        # the global step counter indexes the step draws
        "steps_taken": int(trainer.steps_taken),
        "bundle_key": [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
        "torch_bundle_seed": seed,
        "optim_frames": int(trainer.optim_frames),
        "noise_std": float(trainer.noise_std),
        "last_is_keyframe": bool(trainer.last_is_keyframe),
        # the scene frame: the params mean nothing under another one
        "bounds_transform": trainer.bounds_transform_np.tolist(),
        "scene_extents": trainer.scene_extents_np.tolist(),
        # the model description: the archive serves without a config
        "model": model_meta(m),
        "frames": [{"frame_id": int(f.frame_id)}
                   for f in trainer.frames.frames],
    }
    arrs = {}
    opt = trainer.opt_state
    trees = [
        ("params", tree_leaves(M.params_to_jax(trainer.params, m))),
        ("opt", [_np(opt["count"]).astype(np.int32)]
         + tree_leaves(M.params_to_jax(opt["mu"], m))
         + tree_leaves(M.params_to_jax(opt["nu"], m))),
        ("buf", _buffer_leaves(trainer.buffer)),
        ("frozen", tree_leaves(M.params_to_jax(trainer.frozen_params, m))),
    ]
    for name, leaves in trees:
        for i, leaf in enumerate(leaves):
            arrs[f"{name}/{i}"] = _np(leaf)
    arrs["torch/kf_gen"] = trainer._kf_gen.get_state().numpy()
    arrs["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    # a file object: np.savez would append ".npz" to another extension
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrs)


def _read_leaves(z, prefix: str, refs):
    out = []
    for i, ref in enumerate(refs):
        a = z[f"{prefix}{i}"]
        if a.shape != tuple(np.shape(ref)):
            raise ValueError(
                f"checkpoint leaf {prefix}{i} has shape {a.shape}, expected "
                f"{tuple(np.shape(ref))} (different model or optimiser-state "
                "layout?)")
        out.append(a)
    return out


def read_params(z, prefix: str, model: M.SDFModel, template, device):
    """Port parameters from the archive's ``prefix`` leaves; ``template``
    is a pytree of the expected shapes (params_to_jax)."""
    leaves = _read_leaves(z, prefix, tree_leaves(template))
    return M.params_from_jax(tree_unflatten(template, leaves), model,
                             device=device)


def _read_opt(z, template, model, device):
    """optax.adamw's (count, mu, nu) with mu and nu in ``template``'s
    layout; ValueError for any other layout."""
    refs = tree_leaves(template)
    n = sum(1 for k in z.files if k.startswith("opt/"))
    if n != 1 + 2 * len(refs):
        raise ValueError(f"{n} optimiser leaves, not optax's (count, mu, "
                         "nu) in the model's layout")
    leaves = _read_leaves(z, "opt/", [np.zeros(())] + refs * 2)
    mu, nu = leaves[1:1 + len(refs)], leaves[1 + len(refs):]
    return {"count": torch.full((), int(leaves[0]), dtype=torch.int32,
                                device=device),
            "mu": M.params_from_jax(tree_unflatten(template, mu), model,
                                    device=device),
            "nu": M.params_from_jax(tree_unflatten(template, nu), model,
                                    device=device)}


def _read_buffer(z, buf: FrameBuffer, device) -> FrameBuffer:
    leaves = _read_leaves(z, "buf/", [_np(x) for x in _buffer_leaves(buf)])
    t = [torch.as_tensor(a, device=device) for a in leaves[:-1]]
    if buf.normals is None:
        t.insert(2, None)
    return FrameBuffer(depth=t[0], T_WC=t[1], normals=t[2],
                       frame_avg_loss=t[3], loss_approx=t[4],
                       frame_id=t[5].to(torch.int32), count=int(leaves[-1]))


def load_checkpoint(path: str, trainer) -> Dict[str, Any]:
    """Restore ``trainer`` from an archive of either package. The host
    frame store is rebuilt from the arena's rows (the archive keeps the
    arena, not every ingested frame), so meshing and the keyframe test
    read the restored frames."""
    dev = trainer.device
    m = trainer.model
    template = M.params_to_jax(trainer.params, m)
    with np.load(path, allow_pickle=False) as z:
        meta = read_meta(z)
        params = read_params(z, "params/", m, template, dev)
        frozen = read_params(z, "frozen/", m, template, dev)
        try:
            opt = _read_opt(z, template, m, dev)
        except (KeyError, ValueError) as e:
            print(f"[checkpoint] optimiser state not restored ({e}); "
                  "re-initialising moments")
            opt = fused_adamw.init_state(params)
            meta["opt_state_reinitialised"] = True
        buf = _read_buffer(z, trainer.buffer, dev)
        kf_state = z["torch/kf_gen"] if "torch/kf_gen" in z.files else None

    trainer.params, trainer.frozen_params = params, frozen
    trainer.opt_state, trainer.buffer = opt, buf
    if kf_state is not None:
        cur = trainer._kf_gen.get_state()
        if cur.numel() == kf_state.size:   # written on the same device type
            trainer._kf_gen.set_state(torch.from_numpy(kf_state.copy()))
    trainer.tot_step_time = meta["tot_step_time"]
    trainer.steps_since_frame = meta["steps_since_frame"]
    if "steps_taken" in meta:
        trainer.steps_taken = meta["steps_taken"]
    if "torch_bundle_seed" in meta:
        trainer._bundle_seed = int(meta["torch_bundle_seed"])
    trainer.optim_frames = meta["optim_frames"]
    trainer.noise_std = meta["noise_std"]
    trainer.last_is_keyframe = meta["last_is_keyframe"]
    if "bounds_transform" in meta:
        trainer.set_scene_properties(
            np.asarray(meta["bounds_transform"], np.float32),
            np.asarray(meta["scene_extents"], np.float32))
    depth = buf.depth[:buf.count].cpu().numpy()
    T_WC = buf.T_WC[:buf.count].cpu().numpy()
    fids = buf.frame_id[:buf.count].cpu().numpy()
    trainer.frames = FrameStore()
    for i in range(buf.count):
        trainer.frames.add(FrameData(frame_id=int(fids[i]), image=None,
                                     depth=depth[i], T_WC=T_WC[i]))
    return meta


def _state_dict_np(path_or_dict):
    if isinstance(path_or_dict, str):
        ck = torch.load(path_or_dict, map_location="cpu", weights_only=False)
        path_or_dict = ck.get("model_state_dict", ck)
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in path_or_dict.items()}


def load_reference_state_dict(path_or_dict, params, model: M.SDFModel):
    """Port parameters from a reference torch checkpoint (a path to a .pth,
    reference train/train.py:207-219, or a loaded state_dict). Layers
    (reference fc_map.py:63-111): in_layer.0 -> in, mid1.k.0 -> mid1[k],
    cat_layer.0 -> cat, mid2.k.0 -> mid2[k], out_alpha -> out; a torch
    Linear's weight [out, in] is transposed. A Gaussian embedding's B is
    kept from ``params``."""
    sd = _state_dict_np(path_or_dict)

    def lin(prefix):
        return {"w": np.asarray(sd[prefix + ".weight"], np.float32).T,
                "b": np.asarray(sd[prefix + ".bias"], np.float32)}

    B = model.hidden_layers_block
    tree = {"in": lin("in_layer.0"),
            "mid1": [lin(f"mid1.{k}.0") for k in range(B)],
            "cat": lin("cat_layer.0"),
            "mid2": [lin(f"mid2.{k}.0") for k in range(B)],
            "out": lin("out_alpha")}
    if "B" in params:
        tree["B"] = params["B"].detach().cpu().numpy()
    return M.params_from_jax(tree, model, device=params["Wp"].device)


def save_reference_checkpoint(path_or_none, params, model: M.SDFModel,
                              step: int = 0, loss: float = 0.0):
    """The reference's checkpoint dict ({step, model_state_dict,
    optimizer_state_dict, loss}, train/train.py:207-219) of the port's
    parameters, so the reference's tools (eval/plot_utils.py:17-60) read a
    map trained here; written with torch.save when a path is given."""
    tree = M.params_to_jax(params, model)

    def lin(prefix, p):
        return {prefix + ".weight": torch.from_numpy(
                    np.ascontiguousarray(p["w"].T, np.float32)),
                prefix + ".bias": torch.from_numpy(
                    np.ascontiguousarray(p["b"], np.float32))}

    sd: Dict[str, Any] = {}
    sd.update(lin("in_layer.0", tree["in"]))
    for k, p in enumerate(tree["mid1"]):
        sd.update(lin(f"mid1.{k}.0", p))
    sd.update(lin("cat_layer.0", tree["cat"]))
    for k, p in enumerate(tree["mid2"]):
        sd.update(lin(f"mid2.{k}.0", p))
    sd.update(lin("out_alpha", tree["out"]))
    ck = {"step": int(step), "model_state_dict": sd,
          "optimizer_state_dict": {}, "loss": float(loss)}
    if path_or_none is not None:
        torch.save(ck, path_or_none)
    return ck
