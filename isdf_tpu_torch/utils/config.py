"""Typed config system.

The reference flattens raw JSON imperatively into ~70 Trainer attributes
(reference: isdf/modules/trainer.py:157-333, configs at
isdf/train/configs/*.json). Here the same JSON schema is parsed once into a
frozen dataclass so that the hyperparameters can be closed over by jitted
functions (hashable, immutable) and validated in one place.

The loader accepts the reference's exact config files unchanged, including
the older schema found in shipped results (``render``/``sample_kp``/``track``
sections are ignored, overlapping keys mapped).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    w: int
    h: int
    fx: float
    fy: float
    cx: float
    cy: float
    # optional radial/tangential distortion (reference: trainer.py:180-189)
    distortion: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class Config:
    # --- dataset (reference: trainer.py:158-221) ---
    dataset_format: str = "replicaCAD"
    seq_dir: Optional[str] = None
    gt_sdf_dir: Optional[str] = None
    scannet_dir: Optional[str] = None
    intrinsics_file: Optional[str] = None
    noisy_depth: bool = False
    # synthetic-only: SE(3) twist std (rad/m) perturbing REPORTED poses
    # while depth renders from the true pose — the pose-refinement
    # evaluation scenario (data/synthetic.py, engine/pose.py);
    # mode "iid" (independent) or "walk" (tracker-drift random walk)
    pose_noise_std: float = 0.0
    pose_noise_mode: str = "iid"
    depth_scale: float = 1.0  # raw depth units per metre
    fps: float = 30.0
    camera: CameraConfig = CameraConfig(1200, 680, 600.0, 600.0, 599.5, 339.5)
    im_indices: Tuple[int, ...] = ()
    n_views: int = 0
    random_views: bool = False

    # --- eval (reference: trainer.py:259-292) ---
    do_vox_comparison: bool = False
    eval_pts_root: Optional[str] = None
    do_eval: bool = False
    eval_freq_s: float = 1.0
    sdf_eval: bool = True
    mesh_eval: bool = False
    # fixed-protocol sample count (reference eval_pts.py:96 n_samples
    # default 200000); the eval_pts mask tree bakes this count, so
    # fixture-generated trees carry their own value in the config
    eval_samples: int = 200000

    # --- save (reference: trainer.py:294-300) ---
    save_period: float = 10.0
    save_checkpoints: bool = False
    save_slices: bool = False
    save_meshes: bool = False

    # --- optimiser (reference: trainer.py:320-322) ---
    lr: float = 0.0013
    weight_decay: float = 0.012

    # --- trainer ---
    n_steps: int = 20000

    # --- model (reference: trainer.py:227-257) ---
    refine_poses: bool = False
    pose_lr: float = 0.0004
    # pose-refinement steps run (as one scan bundle) after each frame
    # ingestion when refine_poses is on (engine/loop.py)
    pose_iters: int = 10
    # discard a burst's correction when its relative loss improvement is
    # below this (weak evidence = map-bias noise, not drift signal; 0.25
    # calibrated on the mild-drift A/B where 0.1 still let harmful
    # corrections through — experiments/README.md)
    pose_min_rel_improve: float = 0.25
    # skip the burst entirely when the latest keyframe check already
    # rendered >= this proportion of sampled pixels within threshold
    # (no drift evidence -> a burst can only add map-bias noise); the
    # keyframe decision threshold kf_pixel_ratio is 0.65, so 0.85 means
    # "comfortably better explained than a keyframe boundary". 0 = off
    pose_skip_prop: float = 0.85
    scale_output: float = 0.14
    noise_std: float = 0.25
    noise_kf: float = 0.08
    noise_frame: float = 0.04
    window_size: int = 5
    hidden_layers_block: int = 2
    hidden_feature_size: int = 256
    frac_time_perception: float = 1.0
    iters_per_kf: int = 60
    iters_per_frame: int = 10
    kf_dist_th: float = 0.1
    kf_pixel_ratio: float = 0.65
    # embedding
    scale_input: float = 0.05937489
    n_embed_funcs: int = 5
    gauss_embed: bool = False
    gauss_embed_std: float = 11.0
    # accepted for config compatibility; ignored BY DESIGN: the reference
    # parses optim_embedding but never optimises the embedding either (its
    # gauss B matrix is fixed at init; isdf/modules/embedding.py:25-73)
    optim_embedding: bool = False

    # --- loss (reference: trainer.py:302-318) ---
    bounds_method: str = "ray"  # ray | normal | pc
    loss_type: str = "L1"  # L1 | L2
    trunc_weight: float = 5.38344020
    trunc_distance: float = 0.29365022
    eik_weight: float = 0.268
    eik_apply_dist: float = 0.1
    grad_weight: float = 0.018
    orien_loss: bool = False

    # --- sampling (reference: trainer.py:324-333) ---
    min_depth: float = 0.07
    max_depth: float = 12.0
    dist_behind_surf: float = 0.1
    n_rays: int = 200
    n_rays_is_kf: int = 400
    n_strat_samples: int = 19
    n_surf_samples: int = 8

    # --- TPU-native additions (no reference equivalent) ---
    # fixed capacity of the device-resident keyframe arena
    kf_buffer_size: int = 160
    # arena-full policy: "lowest" evicts the lowest-replay-priority old
    # keyframe (order-preserving compaction); "error" fails loudly
    kf_eviction: str = "lowest"
    # loss-guided active pixel sampling (the reference stubs this,
    # trainer.py:988-1001): a fraction of each frame's rays target image
    # blocks proportionally to the maintained loss_approx grid
    do_active: bool = False
    active_frac: float = 0.5
    # refinement-tail settling (after ingestion ends; loop.py): cosine-
    # anneal the lr down to tail_lr_min x lr over the extra steps, and draw
    # the whole window loss-proportionally from ALL keyframes instead of
    # forcing the two newest (the reference keeps lr and the newest-2 rule,
    # which leaves the field oscillating — docs/ROADMAP.md divergences)
    tail_lr_min: float = 0.05
    tail_loss_window: bool = True
    # steps executed per device call (lax.scan bundle); 1 == reference-exact
    # per-step host loop, larger values amortise dispatch.
    steps_per_bundle: int = 0  # 0 => auto (= current optim_frames budget)
    # cap the effective optimisation rate at this many steps per
    # perception-second (0 = off). When the chip is faster than the cap,
    # each step is billed at least 1/cap seconds of perception time, so
    # the trainer takes FEWER steps per incoming frame and the surplus
    # chip time is explicitly idle — available to other scenes
    # (parallel/multi_scene.py) or ensemble members. Motivated by the
    # measured quality-vs-compute curve (experiments/quality_compute_curve):
    # the campaign protocol is U-shaped in step rate with its minimum at
    # ~123 steps/s (paired -0.20 cm vs the natural 246, +0.17 cm at the
    # full 633), i.e. running the chip flat-out over-fits each frame
    # window before the next frame arrives. This is the reference's
    # frac_time_perception trade (isdf/modules/trainer.py:273-283) recast
    # as an absolute rate, which is the knob the curve is measured in.
    step_rate_cap: float = 0.0
    # compute dtype for the MLP matmuls ("float32" or "bfloat16")
    compute_dtype: str = "float32"
    # MXU precision for the MLP hidden matmuls: default|high|highest
    mm_precision: str = "default"
    # rematerialise the MLP in the outer backward (trades FLOPs for HBM)
    remat: bool = False
    # use Pallas kernels on TPU (bounds_pc nearest-surface search)
    use_pallas: bool = False
    # spatial-gradient executor: "pallas" (monolithic fused loss+grad
    # Mosaic kernel, models/pallas_mlp.py — fastest on TPU, falls back to
    # reverse_fused off-TPU), "reverse_fused" (hand-derived custom VJP,
    # models/fused_vjp.py) or "auto" (XLA autodiff)
    grad_mode: str = "pallas"
    # run the pallas train kernel in interpreter mode (CPU testing only)
    pallas_interpret: bool = False
    # build the positional encoding INSIDE the monolithic train kernel
    # (one dot against the packed affine plane + sin/cos) instead of
    # streaming a [N,256] pe tensor from HBM
    pe_in_kernel: bool = True
    # compute the batch-distance (pc) bound targets inside the kernel
    # too (the XLA path materialises a [N,R] f32 score matrix in HBM);
    # requires pe_in_kernel; only applies when loss.bounds_method == pc
    pc_in_kernel: bool = True
    # batch-distance surface-set budget: cap the pc-bounds surface set
    # at this many points (valid-first random subsample). The [N, R_surf]
    # score matrix is the step's only quadratically-scaling term
    # (experiments/scaling_probe.py); the cap keeps pc cost linear in
    # the ray count while preserving the bound quality of the
    # reference's shipped 1000-ray workload. Budget >= surf count (all
    # shipped configs at 1x rays) is the exact full set. 0 = no cap.
    pc_surf_budget: int = 1000
    # data-parallel devices for the ray batch (1 == single chip)
    data_parallel: int = 1
    # host workspace overrides (realsense_franka-style; reference trainer.py:114-119)
    workspace_center: Optional[Tuple[float, float, float]] = None
    workspace_extents: Optional[Tuple[float, float, float]] = None
    workspace_rotate_z: float = 0.0
    workspace_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ext_calib: Optional[str] = None
    # live-mode transport: directory a bridge process drops frame*.npz
    # files into (our transport-agnostic stand-in for the reference's
    # ROS topics, isdf/ros_utils/node.py:99-168)
    live_dir: Optional[str] = None
    # "dir" (frame*.npz watch) or "ros" (rospy topics via data/ros_node.py,
    # matching the reference's iSDFNode/iSDFFrankaNode transports)
    live_transport: str = "dir"

    # ----- derived -----
    @property
    def do_normal(self) -> bool:
        # reference: trainer.py:316-318
        return self.bounds_method == "normal" or self.grad_weight != 0.0

    @property
    def n_samples_per_ray(self) -> int:
        return self.n_strat_samples + self.n_surf_samples

    @property
    def embedding_size(self) -> int:
        if self.gauss_embed:
            # matched to icosahedron size so network shape is identical
            n_freqs = self.n_embed_funcs + 1
            return 2 * 21 * n_freqs + 3
        n_freqs = self.n_embed_funcs + 1  # min_deg=0..max_deg inclusive
        return 2 * 21 * n_freqs + 3

    @property
    def live(self) -> bool:
        return self.dataset_format in ("arkit", "realsense", "realsense_franka")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _get(d, *path, default=None):
    for p in path:
        if not isinstance(d, dict) or p not in d:
            return default
        d = d[p]
    return d


def config_from_dict(cfg: dict) -> Config:
    """Build a Config from a reference-schema JSON dict."""
    cam_d = _get(cfg, "dataset", "camera", default=None)
    cam = Config.camera
    if cam_d is not None:
        dist = tuple(
            cam_d[k] for k in ("k1", "k2", "p1", "p2", "k3") if k in cam_d
        )
        cam = CameraConfig(
            w=int(cam_d["w"]), h=int(cam_d["h"]),
            fx=float(cam_d["fx"]), fy=float(cam_d["fy"]),
            cx=float(cam_d["cx"]), cy=float(cam_d["cy"]),
            distortion=dist,
        )

    emb = _get(cfg, "model", "embedding", default={}) or {}
    ws = cfg.get("workspace", {}) or {}

    kw = dict(
        dataset_format=_get(cfg, "dataset", "format", default="replicaCAD"),
        seq_dir=_get(cfg, "dataset", "seq_dir"),
        gt_sdf_dir=_get(cfg, "dataset", "gt_sdf_dir"),
        scannet_dir=_get(cfg, "dataset", "scannet_dir"),
        intrinsics_file=_get(cfg, "dataset", "intrinsics_file"),
        noisy_depth=bool(_get(cfg, "dataset", "noisy_depth", default=0)),
        pose_noise_std=float(_get(cfg, "dataset", "pose_noise_std",
                                  default=0.0)),
        pose_noise_mode=_get(cfg, "dataset", "pose_noise_mode",
                             default="iid"),
        depth_scale=float(_get(cfg, "dataset", "depth_scale", default=1.0)),
        fps=float(_get(cfg, "dataset", "fps", default=30.0)),
        camera=cam,
        im_indices=tuple(_get(cfg, "dataset", "im_indices", default=()) or ()),
        n_views=int(_get(cfg, "dataset", "n_views", default=0)),
        random_views=bool(_get(cfg, "dataset", "random_views", default=0)),
        do_vox_comparison=bool(_get(cfg, "eval", "do_vox_comparison", default=0)),
        eval_pts_root=_get(cfg, "eval", "eval_pts_root"),
        do_eval=bool(_get(cfg, "eval", "do_eval", default=0)),
        eval_freq_s=float(_get(cfg, "eval", "eval_freq_s", default=1.0)),
        sdf_eval=bool(_get(cfg, "eval", "sdf_eval", default=1)),
        mesh_eval=bool(_get(cfg, "eval", "mesh_eval", default=0)),
        eval_samples=int(_get(cfg, "eval", "eval_samples", default=200000)),
        save_period=float(_get(cfg, "save", "save_period", default=10.0)),
        save_checkpoints=bool(_get(cfg, "save", "save_checkpoints", default=0)),
        save_slices=bool(_get(cfg, "save", "save_slices", default=0)),
        save_meshes=bool(_get(cfg, "save", "save_meshes", default=0)),
        lr=float(_get(cfg, "optimiser", "lr", default=0.0013)),
        weight_decay=float(_get(cfg, "optimiser", "weight_decay", default=0.012)),
        n_steps=int(_get(cfg, "trainer", "steps", default=20000)),
        refine_poses=bool(_get(cfg, "model", "refine_poses", default=0)),
        pose_lr=float(_get(cfg, "pose_refine", "pose_lr", default=0.0004)),
        pose_iters=int(_get(cfg, "pose_refine", "pose_iters", default=10)),
        pose_min_rel_improve=float(_get(cfg, "pose_refine",
                                        "min_rel_improve", default=0.25)),
        pose_skip_prop=float(_get(cfg, "pose_refine", "skip_prop",
                                  default=0.85)),
        do_active=bool(_get(cfg, "model", "do_active", default=0)),
        scale_output=float(_get(cfg, "model", "scale_output", default=0.14)),
        noise_std=float(_get(cfg, "model", "noise_std", default=0.25)),
        noise_kf=float(_get(cfg, "model", "noise_kf", default=0.08)),
        noise_frame=float(_get(cfg, "model", "noise_frame", default=0.04)),
        window_size=int(_get(cfg, "model", "window_size", default=5)),
        hidden_layers_block=int(_get(cfg, "model", "hidden_layers_block", default=2)),
        hidden_feature_size=int(_get(cfg, "model", "hidden_feature_size", default=256)),
        frac_time_perception=float(_get(cfg, "model", "frac_time_perception", default=1.0)),
        iters_per_kf=int(_get(cfg, "model", "iters_per_kf", default=60)),
        iters_per_frame=int(_get(cfg, "model", "iters_per_frame", default=10)),
        kf_dist_th=float(_get(cfg, "model", "kf_dist_th", default=0.1)),
        kf_pixel_ratio=float(_get(cfg, "model", "kf_pixel_ratio", default=0.65)),
        scale_input=float(emb.get("scale_input", 0.05937489)),
        n_embed_funcs=int(emb.get("n_embed_funcs", 5)),
        gauss_embed=bool(emb.get("gauss_embed", 0)),
        gauss_embed_std=float(emb.get("gauss_embed_std", 11.0)),
        optim_embedding=bool(emb.get("optim_embedding", 0)),
        bounds_method=_get(cfg, "loss", "bounds_method",
                           default=cfg.get("sdf_supervision", "ray")),
        loss_type=_get(cfg, "loss", "loss_type", default="L1"),
        trunc_weight=float(_get(cfg, "loss", "trunc_weight", default=5.38344020)),
        trunc_distance=float(_get(cfg, "loss", "trunc_distance", default=0.29365022)),
        eik_weight=float(_get(cfg, "loss", "eik_weight", default=0.268)),
        eik_apply_dist=float(_get(cfg, "loss", "eik_apply_dist", default=0.1)),
        grad_weight=float(_get(cfg, "loss", "grad_weight", default=0.018)),
        orien_loss=bool(_get(cfg, "loss", "orien_loss", default=0)),
        min_depth=float(_get(cfg, "sample", "depth_range", default=[0.07, 12.0])[0]),
        max_depth=float(_get(cfg, "sample", "depth_range", default=[0.07, 12.0])[1]),
        dist_behind_surf=float(_get(cfg, "sample", "dist_behind_surf", default=0.1)),
        n_rays=int(_get(cfg, "sample", "n_rays", default=200)),
        n_rays_is_kf=int(_get(cfg, "sample", "n_rays_is_kf", default=400)),
        n_strat_samples=int(_get(cfg, "sample", "n_strat_samples", default=19)),
        n_surf_samples=int(_get(cfg, "sample", "n_surf_samples", default=8)),
        ext_calib=cfg.get("ext_calib"),
        live_dir=_get(cfg, "dataset", "live_dir"),
        live_transport=_get(cfg, "dataset", "live_transport", default="dir"),
    )

    # TPU-native extension block (ours)
    tpu = cfg.get("tpu", {}) or {}
    for k in ("kf_buffer_size", "kf_eviction", "steps_per_bundle",
              "compute_dtype", "mm_precision", "remat", "use_pallas",
              "grad_mode", "pallas_interpret", "data_parallel",
              "do_active", "active_frac", "tail_lr_min",
              "tail_loss_window", "pe_in_kernel", "pc_in_kernel",
              "pc_surf_budget", "step_rate_cap"):
        if k in tpu:
            kw[k] = tpu[k]

    if ws:
        kw.update(
            workspace_center=tuple(ws.get("center", (0, 0, 0))),
            workspace_extents=tuple(ws.get("extents", (1, 1, 1))),
            workspace_rotate_z=float(ws.get("rotate_z", 0.0)),
            workspace_offset=tuple(ws.get("offset", (0, 0, 0))),
        )

    c = Config(**kw)
    assert c.bounds_method in ("ray", "normal", "pc"), c.bounds_method
    assert c.loss_type in ("L1", "L2"), c.loss_type
    return c


def apply_overrides(cfg: dict, overrides) -> dict:
    """Apply CLI ``section.key=value`` overrides to a raw config dict.

    Values are JSON-parsed when possible (``=ros`` stays a string,
    ``=0.5``/``=true``/``=[1,2]`` become typed); dotted paths create
    intermediate sections. The reference has no CLI overrides (its batch
    sweeps GENERATE config files, batch_utils.py:246-436) — this is the
    ergonomic replacement that keeps shipped configs pristine."""
    for item in overrides or ():
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"--set expects section.key=value, got {item!r}")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return cfg


def load_config(path: str, overrides=None) -> Config:
    with open(path) as f:
        cfg = json.load(f)
    c = config_from_dict(apply_overrides(cfg, overrides))
    # resolve relative paths against the config file location, like running
    # the reference CLI from its train/ directory would
    base = os.path.dirname(os.path.abspath(path))

    def _resolve(p):
        if p is None or os.path.isabs(p):
            return p
        return os.path.normpath(os.path.join(base, p))

    return c.replace(
        seq_dir=_resolve(c.seq_dir),
        gt_sdf_dir=_resolve(c.gt_sdf_dir),
        scannet_dir=_resolve(c.scannet_dir),
        intrinsics_file=_resolve(c.intrinsics_file),
        eval_pts_root=_resolve(c.eval_pts_root),
        live_dir=_resolve(c.live_dir),
    )



def scannet_cam_params(path: str) -> CameraConfig:
    """Parse a ScanNet scene info txt (reference trainer.py:335-346):
    `key = value` lines with fx_depth/fy_depth/mx_depth/my_depth and
    depthWidth/depthHeight."""
    info = {}
    with open(path) as f:
        for line in f.read().splitlines():
            if " = " in line:
                k, v = line.split(" = ", 1)
                info[k.strip()] = v.strip()
    return CameraConfig(
        w=int(info["depthWidth"]), h=int(info["depthHeight"]),
        fx=float(info["fx_depth"]), fy=float(info["fy_depth"]),
        cx=float(info["mx_depth"]), cy=float(info["my_depth"]))
