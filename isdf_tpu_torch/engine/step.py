"""The training engine: one optimisation step, bundles of steps, and the
keyframe test (isdf_tpu/engine/step.py in eager torch).

Each step selects the keyframe window (Gumbel top-k over log replay
priorities, reference trainer.py:652-674), samples pixels and depths,
gathers the pixels from the arena, computes the loss and its parameter
gradient, applies AdamW on the packed parameter planes and writes the
per-frame losses back for replay priority.

The loss and gradient take one of two routes, chosen as isdf_tpu chooses
(its step.py:142-147):

* the fused train op (models/cuda_mlp.py: the hand-written CUDA kernel K1
  on the card, its plain version on the CPU) with ``grad_mode: "pallas"``
  and the spatial-gradient losses on. ``tpu.pe_in_kernel`` builds the PE
  in the kernel (else the PE is streamed in, K1-stream) and
  ``tpu.pc_in_kernel`` the batch-distance bounds too;
* autograd over ``ray_batch_loss`` otherwise: ``grad_mode:
  "reverse_fused"`` (the hand-derived op of models/fused_vjp.py on plain
  ops), ``"auto"`` (nested autograd through the MLP), the pallas mode
  where the fused op is not built (the reverse-fused op of
  models/cuda_reverse_fused.py, kernels K2/K3 on the card), or a plain
  forward when the eikonal and gradient weights are both 0. The Gaussian
  embedding (``model.gauss_embed``) always takes nested autograd, its
  matrix B trained with the MLP, as in isdf_tpu (step.py:146, 197).

``tpu.mm_precision`` other than "default" runs the kernels K1-K3 in their
f32-product mode (csrc/*_f32.cu), as isdf_tpu builds its Pallas kernels
with mm_dtype = float32.

``tpu.use_pallas`` sends the pc bounds computed outside the fused op to the
nearest-surface kernel K4 (ops/cuda_bounds.py; its plain version on the
CPU); it has no effect where the fused op computes the bounds.
``tpu.compute_dtype: "bfloat16"`` runs the eager forward's hidden layers in
bf16 (models/sdf_mlp.py::apply): the autograd routes and the keyframe
test; the kernels K1-K3 ignore it, as isdf_tpu's Pallas ops do. The
TPU-only knobs tpu.pallas_interpret, tpu.remat, the ISDF_PALLAS_TM /
ISDF_PALLAS_FAST32 environment variables and the scoped-VMEM compiler
option have no effect here.

Step t of the run draws from the generator seeded with step_seed(seed,
global step), so a trajectory does not depend on how steps are cut into
bundles. Parameters, optimiser state and the arena's priority rows are
updated in place. A step reads its noise scale, learning-rate scale and the
arena's fill count from its row of a small table on the device
(``step_table``); the branches it takes on the host (the window's, the
refinement tail's and, for an arena smaller than the window, the fill
count) are its key.

The step's per-point work runs over the shards of a "dp" mesh
(parallel/mesh.py; isdf_tpu's ``build_step_functions(mesh=)``): the
``mesh`` given, else a mesh of one shard on ``device``. Window selection,
sampling, noise, the surface set and the bounds are global, on the mesh's
first device; then the fused op runs once per shard on that shard's
contiguous rays (the global surface set, normaliser and weights given to
every shard) and its sums and gradients are added in shard order
(isdf_tpu's shard_map and psum, step.py:285-305). Without the fused op
the spatial forward runs once per shard, on the card the reverse-fused op
(K2 forward, K3 backward), and the losses on the whole batch; each shard's
parameter gradient comes from leaves of its own and the gradients are
added in shard order. A mesh of several shards builds the fused op only
with ``pe_in_kernel``, as isdf_tpu gates it. The arena, parameters and
optimiser state stay on the first device. On one shard the cuts are views
and the sums and gathers the shard's own tensors, so the one-shard step
launches no kernel a mesh adds.

On the card a bundle is one captured step replayed (isdf_tpu runs a bundle
as one compiled ``lax.scan``): each key's first step runs eagerly, then is
captured as a CUDA graph (utils/graphs.py), and every later step of that
key seeds the generator, copies its table row into the graph's input and
replays; the replay draws what the eager step draws. The graphs read the
parameters, moments and arena at the addresses they were captured with, so
replacing any of those tensors (a checkpoint load) drops them. On the CPU,
with ``StepFunctions(eager=True)`` (the card's yardstick in tests and
chip_smoke.py), or on a mesh across several cards (a capture records one
card's stream), a bundle is a plain loop of steps. A mesh whose shards
share one card is captured as one shard is.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

from isdf_tpu_torch.engine.buffer import FrameBuffer
from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.models.cuda_mlp import (HID, blocks_per_sm,
                                            make_train_op, source, variant)
from isdf_tpu_torch.models.cuda_reverse_fused import make_cuda_reverse_fused
from isdf_tpu_torch.models.fused_adamw import make_fused_adamw
from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp
from isdf_tpu_torch.ops import bounds as B
from isdf_tpu_torch.ops import losses as L
from isdf_tpu_torch.ops import render as R
from isdf_tpu_torch.ops import sampling as S
from isdf_tpu_torch.parallel import mesh as PM
from isdf_tpu_torch.utils.config import Config
from isdf_tpu_torch.utils.profiling import span

_MASK64 = (1 << 64) - 1
# the trained parameters, in the order of a step's gradients
PARAM_KEYS = ("Wp", "bp", "B")


def step_seed(seed: int, step: int) -> int:
    """splitmix64 of (seed, step): the generator seed of one global step."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def step_table(n_steps: int, noise_std: float, lr_scale: float, count: int,
               device):
    """The per-step scalars of a bundle, [n_steps, 3] float32 on the
    device: row t holds step t's (noise_std, lr_scale, arena fill count),
    each rounded to float32 as isdf_tpu traces them. Filled on the device,
    so a bundle copies nothing from the host."""
    tab = torch.empty((n_steps, 3), device=device)
    for j, v in enumerate((noise_std, lr_scale, count)):
        tab[:, j].fill_(float(v))
    return tab


def select_window(gen, count: int, frame_avg_loss, window_size: int,
                  tail: bool = False, g=None, count_t=None):
    """The active keyframe window (reference trainer.py:652-674): the two
    newest frames plus window_size-2 older ones drawn without replacement
    with p proportional to their average loss (Gumbel top-k). With
    <= window_size frames the window is all frames plus masked padding.
    ``tail``: the refinement tail draws the whole window from all
    keyframes. ``g``: the [C] Gumbel draws (always drawn, so the
    generator's stream does not depend on the branch taken). ``count``
    picks the branch; ``count_t``, the same count as an int64 tensor on the
    device, gives the values, so that nothing is copied from the host.

    Returns (idxs [window_size] int64, valid [window_size] bool)."""
    C = frame_avg_loss.shape[0]
    dev = frame_avg_loss.device
    if g is None:
        g = S.gumbel(gen, (C,), dev)
    n = count if count_t is None else count_t
    ar = torch.arange(window_size, device=dev)
    if count <= window_size:
        return ar, ar < n
    logits = torch.log(frame_avg_loss.clamp(min=1e-30))
    pos = torch.arange(C, device=dev)
    ones = torch.ones(window_size, dtype=torch.bool, device=dev)
    if not tail:
        logits = torch.where(pos < n - 2, logits, -torch.inf)
        top = torch.topk(logits + g, window_size - 2).indices
        newest = torch.arange(2, device=dev) + (n - 2)
        return torch.cat([top, newest]), ones
    logits = torch.where(pos < n, logits, -torch.inf)
    kk = min(window_size, C)
    top = torch.topk(logits + g, kk).indices
    pad = torch.zeros(window_size - kk, dtype=top.dtype, device=dev)
    return torch.cat([top, pad]), ones


class StepFunctions:
    """The engine specialised to a config, a model and a camera."""

    def __init__(self, cfg: Config, model: M.SDFModel, H: int, W: int,
                 dirs_C_img, device, eager: bool = False,
                 mesh: PM.Mesh = None):
        self.cfg, self.model, self.H, self.W = cfg, model, H, W
        self.device = torch.device(device)
        own = PM.Mesh([self.device])
        self.mesh = own if mesh is None else mesh
        if self.mesh.first != own.first:
            raise ValueError(f"the step runs on {self.device}, the mesh's "
                             f"first device is {mesh.first}")
        self.dirs = dirs_C_img.to(self.device)
        if cfg.grad_mode not in ("pallas", "reverse_fused", "auto"):
            raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
        cuda = self.device.type == "cuda"
        self.do_sdf_grad = cfg.eik_weight != 0 or cfg.grad_weight != 0
        # the fused train op where isdf_tpu builds its Pallas train op
        # (a mesh of several shards needs pe_in_kernel); its kernel needs
        # hidden 256, its plain version runs at any width
        fused = (cfg.grad_mode == "pallas" and self.do_sdf_grad
                 and (self.mesh.size == 1 or cfg.pe_in_kernel)
                 and (not cuda or model.hidden_size == HID)
                 and not model.gauss_embed)
        self.pc_in_kernel = (fused and cfg.pc_in_kernel and cfg.pe_in_kernel
                             and cfg.bounds_method == "pc")
        self.train_op = self.rf_op = None
        sources = []
        if fused:
            self.train_op = make_train_op(
                model, loss_type=cfg.loss_type,
                trunc_distance=cfg.trunc_distance,
                trunc_weight=cfg.trunc_weight,
                eik_apply_dist=cfg.eik_apply_dist, eik_weight=cfg.eik_weight,
                grad_weight=cfg.grad_weight, orien_loss=cfg.orien_loss,
                pc_bounds=self.pc_in_kernel, pe_in_kernel=cfg.pe_in_kernel)
            sources.append(source("train_mlp", model))
        elif (cfg.grad_mode != "auto" and self.do_sdf_grad
              and not model.gauss_embed):
            # isdf_tpu step.py:207-216: the Pallas op on the accelerator
            if (cfg.grad_mode == "pallas" and cuda
                    and model.hidden_size == HID):
                self.rf_op = make_cuda_reverse_fused(model)
                sources.append(source("reverse_fused", model))
            else:
                self.rf_op = make_reverse_fused_mlp(model)
        if (cfg.use_pallas and cfg.bounds_method == "pc"
                and not self.pc_in_kernel):
            sources.append("bounds_pc")
        # the kernel libraries this step launches (built by the Trainer)
        self.kernel_sources = sources if cuda else []
        self.uses_kernel = bool(self.kernel_sources)
        # what ``step.bundle`` records of the train op a step launches on
        # the card: its variant and lanes ("K1-ray/384"), and the shape of
        # one call (points, embedding lanes, packed layers, surface points);
        # the first bundle adds the build's resident blocks an SM
        # (``blocks_per_sm``), once its library has loaded
        self.bundle_counts = {}
        self.k1_mode = None
        if fused and cuda:
            rays = cfg.window_size * cfg.n_rays
            budget = cfg.pc_surf_budget
            self.k1_mode = ("K1-pc" if self.pc_in_kernel else
                            "K1-ray" if cfg.pe_in_kernel else "K1-stream")
            self.bundle_counts = dict(
                train_op=variant(self.k1_mode, model),
                points=rays * cfg.n_samples_per_ray,
                embedding=model.embedding_size, layers=model.n_layers,
                surface=(min(rays, budget) if budget else rays)
                if self.pc_in_kernel else 0)
        self.adamw = make_fused_adamw(cfg.lr, cfg.weight_decay,
                                      b1=0.9, b2=0.999, eps=1e-8)
        # the graph route on the card; ``eager`` keeps the plain loop there
        self.eager = eager or not cuda
        n_cards = len(self.mesh.distinct)
        if cuda and n_cards > 1:
            if not self.eager:
                print(f"isdf_tpu_torch: the step across {n_cards}"
                      " cards runs eagerly (a CUDA graph captures one card's "
                      "stream)", file=sys.stderr, flush=True)
            self.eager = True
        self.gen = torch.Generator(device=self.device)
        self.graphs = None          # utils/graphs.GraphRunner, at first use
        self._captured = {}         # key -> (Captured, input row, out row)
        self._captured_on = None    # the tensors the graphs were captured on

    # ---------------- one step ----------------
    def surf_set(self, gen, pc, valid):
        """Surface set for the batch-distance bounds, capped at
        cfg.pc_surf_budget points (valid-first random subsample)."""
        surf = pc[:, 0]
        budget = self.cfg.pc_surf_budget
        if not budget or budget >= surf.shape[0]:
            return surf, valid
        score = valid.float() * 2.0 + torch.rand(
            surf.shape[0], generator=gen, device=pc.device)
        sel = torch.topk(score, budget).indices
        return surf[sel], valid[sel]

    def loss_and_grad(self, params, transform, pc, z_vals, dirs_C, dirs_W,
                      depth, normals, valid, noise, surf=None, sv=None):
        """Loss and parameter gradient of one sampled batch -> (scalars,
        ploss [R, S], (dW, db)): the fused train op, or autograd over
        ray_batch_loss where it is not built."""
        if self.train_op is None:
            return self.autograd_loss_and_grad(
                params, transform, pc, z_vals, dirs_C, dirs_W, depth,
                normals, valid, noise, surf=surf, sv=sv)
        cfg = self.cfg
        R_, S_, _ = pc.shape
        N = R_ * S_
        flat = pc.reshape(N, 3).contiguous()
        vflat = valid[:, None].expand(R_, S_).reshape(-1).float()
        C = S_ * valid.sum()
        invC = torch.where(C > 0, 1.0 / C.clamp(min=1).float(),
                           torch.zeros((), device=pc.device))
        if self.pc_in_kernel:
            zd = (z_vals - depth[:, None]).reshape(-1)
            normals_pt = normals[:, None, :].expand(R_, S_, 3).reshape(N, 3)
            is_surf = torch.zeros((R_, S_), device=pc.device)
            is_surf[:, 0] = 1.0
            # the surface set is global: every shard gets all of it
            sums, ploss, grads = self._shard_mapped(
                self.train_op, {2, 5, 6, 7, 8, 9}, params, transform, flat,
                surf.contiguous(), sv.float().contiguous(), zd.contiguous(),
                normals_pt.contiguous(), is_surf.reshape(-1), vflat, noise,
                invC)
        else:
            bnd = B.compute_bounds(
                cfg.bounds_method, dirs_C, depth, dirs_W, z_vals, pc,
                cfg.trunc_distance, normals, valid,
                do_grad=cfg.grad_weight != 0, surf=surf, surf_valid=sv,
                use_kernel=cfg.use_pallas)
            if cfg.grad_weight != 0:
                gv = bnd.grad
                if bnd.grad_valid is not None:
                    gv = torch.where(bnd.grad_valid[..., None], gv,
                                     normals[:, None, :])
                gt = torch.cat([normals[:, None, :], gv], dim=1).reshape(N, 3)
            else:
                gt = torch.zeros((N, 3), device=pc.device)
            rest = (bnd.bounds.reshape(-1).contiguous(), vflat, noise,
                    gt.contiguous(), invC)
            if cfg.pe_in_kernel:
                sums, ploss, grads = self._shard_mapped(
                    self.train_op, {2, 3, 4, 5, 6}, params, transform, flat,
                    *rest)
            else:
                pe, _, dxs, dproj2 = M._pe_factored(flat, self.model,
                                                    transform)
                sums, ploss, grads = self.train_op(params, pe, dxs, dproj2,
                                                   *rest)
        scalars = {"sdf_loss": sums[1] * invC, "total_loss": sums[0] * invC}
        if cfg.grad_weight != 0:
            scalars["grad_loss"] = sums[2] * invC
        if cfg.eik_weight != 0:
            scalars["eikonal_loss"] = sums[3] * invC
        return scalars, ploss.reshape(R_, S_), grads

    def _shard_mapped(self, op, sharded, *args):
        """``op``(*args) -> (sums, ploss, grads), once per shard (isdf_tpu
        step.py:285-305): the args at the positions in ``sharded`` cut
        into the shards' contiguous rows, the others replicated; sums and
        gradients added in shard order, ploss gathered in ray order, all on
        the first device."""
        mesh = self.mesh
        shards = PM.split(mesh, *[args[i] for i in sorted(sharded)])
        reps = {i: PM.replicate(mesh, a) for i, a in enumerate(args)
                if i not in sharded}
        outs = []
        for k, dev in enumerate(mesh.devices):
            cut = dict(zip(sorted(sharded), shards[k]))
            with PM.on(dev):
                outs.append(op(*[cut[i] if i in cut else reps[i][dev]
                                 for i in range(len(args))]))
        sums = PM.fixed_sum(mesh, [o[0] for o in outs])
        ploss = PM.gather(mesh, [o[1] for o in outs])
        grads = tuple(PM.fixed_sum(mesh, [o[2][j] for o in outs])
                      for j in range(len(outs[0][2])))
        return sums, ploss, grads

    def value_and_spatial_grad(self, params, pc, transform):
        """(sdf [R, S], d sdf / dx [R, S, 3]) differentiable in params
        (isdf_tpu step.py:195-226). ``params`` is a list of one dict a
        shard (shard_leaves): shard k's rays go through the forward on its
        device with its own dict."""
        mesh = self.mesh
        trans = PM.replicate(mesh, transform)
        outs = []
        for (pc_k,), p_k, dev in zip(PM.split(mesh, pc), params,
                                     mesh.devices):
            with PM.on(dev):
                outs.append(self._value_and_spatial_grad(p_k, pc_k,
                                                         trans[dev]))
        return tuple(PM.gather(mesh, [o[j] for o in outs])
                     for j in range(2))

    def _value_and_spatial_grad(self, params, pc, transform):
        model = self.model
        if self.rf_op is not None:
            R_, S_, _ = pc.shape
            pe, cos_b, dxs, dproj2 = M._pe_factored(
                pc.reshape(R_ * S_, 3), model, transform)
            raw, graw = self.rf_op(params, pe, cos_b, dxs, dproj2)
            return (raw.reshape(R_, S_) * model.scale_output,
                    graw.reshape(R_, S_, 3) * model.scale_output)
        if not self.do_sdf_grad:
            sdf = M.apply(params, pc, model, transform=transform)
            return sdf, torch.zeros_like(pc)
        x = pc.detach().requires_grad_(True)
        sdf = M.apply(params, x, model, transform=transform)
        (g,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
        return sdf, g

    def ray_batch_loss(self, params, transform, pc, z_vals, dirs_C, dirs_W,
                       depth, normals, valid, noise, surf=None, sv=None):
        """The loss of one batch as isdf_tpu's _ray_batch_loss
        (step.py:187-262), differentiable in params -> L.TotalLoss."""
        cfg = self.cfg
        sdf, sdf_grad = self.value_and_spatial_grad(params, pc, transform)
        sdf = sdf + noise.reshape(sdf.shape) * self.model.scale_output
        bnd = B.compute_bounds(
            cfg.bounds_method, dirs_C, depth, dirs_W, z_vals, pc,
            cfg.trunc_distance, normals, valid,
            do_grad=cfg.grad_weight != 0, surf=surf, surf_valid=sv,
            use_kernel=cfg.use_pallas)
        sdf_mat, free_space = L.sdf_loss(sdf, bnd.bounds, cfg.trunc_distance,
                                         cfg.loss_type)
        eik_mat = grad_mat = None
        if cfg.eik_weight != 0:
            eik_mat = (sdf_grad.norm(dim=-1) - 1.0).abs()
        if cfg.grad_weight != 0:
            grad_mat = L.grad_cosine_loss(sdf_grad, bnd.grad, bnd.grad_valid,
                                          normals, cfg.orien_loss)
        return L.tot_loss(sdf_mat, grad_mat, eik_mat, free_space, bnd.bounds,
                          valid, cfg.eik_apply_dist, cfg.trunc_weight,
                          cfg.grad_weight, cfg.eik_weight)

    def autograd_loss_and_grad(self, params, transform, pc, z_vals, dirs_C,
                               dirs_W, depth, normals, valid, noise,
                               surf=None, sv=None):
        """ray_batch_loss and its gradient in the packed planes (isdf_tpu
        step.py:428-436) -> (scalars, ploss [R, S], (dW, db[, dB])), dB
        the Gaussian embedding's where the model has one. Each shard
        differentiates leaves of its own (shard_leaves) and the shards'
        gradients are added in shard order."""
        leaves = self.shard_leaves(params)
        keys = [k for k in PARAM_KEYS if k in params]
        with torch.enable_grad():
            out = self.ray_batch_loss(
                leaves, transform, pc, z_vals, dirs_C, dirs_W, depth,
                normals, valid, noise, surf=surf, sv=sv)
            flat = torch.autograd.grad(out.total,
                                       [p[k] for p in leaves for k in keys])
        grads = tuple(PM.fixed_sum(self.mesh, flat[j::len(keys)])
                      for j in range(len(keys)))
        scalars = {k: v.detach() for k, v in out.scalars.items()}
        return scalars, out.mat.detach(), grads

    def shard_leaves(self, params):
        """One dict of autograd leaves a shard: views of the parameters on
        each shard's device, copied once per distinct device."""
        reps = PM.replicate(self.mesh, params)
        return [{k: v.detach().requires_grad_(True)
                 for k, v in reps[d].items()} for d in self.mesh.devices]

    def update(self, params, opt_state, buf: FrameBuffer, grads, ploss,
               idxs, slot_valid, ib, ih, iw, valid, lr_scale):
        """AdamW on the packed planes, then the replay-priority write-back
        (reference trainer.py:979): per-frame average loss over an 8x8
        block pooling of the ray losses.

        An arena smaller than the window (C < window_size) only ever
        takes select_window's first branch, whose slots past the arena are
        padding and not valid: their writes are dropped, as isdf_tpu's
        scatters drop out-of-range rows. The sums and counts add 0 for
        them (at a clamped row); the priority grids are written for the
        valid slots only, the first ``count``."""
        self.adamw(params, dict(zip(PARAM_KEYS, grads)), opt_state,
                   lr_scale)
        ray_loss = ploss.sum(-1)
        loss_approx, frame_avg = L.frame_avg_loss(
            ray_loss, valid, ib, ih, iw, self.cfg.window_size, self.H,
            self.W, factor=8)
        C = buf.frame_avg_loss.shape[0]
        dev = ploss.device
        small = C < idxs.shape[0]
        rows = idxs.clamp(max=C - 1) if small else idxs
        sums = torch.zeros(C, device=dev).index_add_(
            0, rows, torch.where(slot_valid, frame_avg, 0.0))
        cnts = torch.zeros(C, device=dev).index_add_(
            0, rows, slot_valid.float())
        buf.frame_avg_loss.copy_(torch.where(
            cnts > 0, sums / cnts.clamp(min=1.0), buf.frame_avg_loss))
        if small:
            n = buf.count
            buf.loss_approx[idxs[:n]] = loss_approx[:n]
        else:
            buf.loss_approx[idxs] = torch.where(
                slot_valid[:, None, None], loss_approx,
                buf.loss_approx[idxs])

    def core(self, params, opt_state, buf: FrameBuffer, transform, gen,
             ins, tail: bool):
        """One step in place -> its scalars. ``ins``: the step's row of
        step_table on the device; ``tail`` and the arena's host fill count
        pick the branches (graph_key)."""
        cfg = self.cfg
        Wn, n_rays, H, W = cfg.window_size, cfg.n_rays, self.H, self.W
        dev = self.device
        noise_std, lr_scale = ins[0], ins[1]
        idxs, slot_valid = select_window(gen, buf.count, buf.frame_avg_loss,
                                         Wn, tail=tail,
                                         count_t=ins[2].long())
        # the arena's rows of the window's slots: clamped where the arena
        # is smaller than the window, as isdf_tpu's gathers clamp (those
        # slots are padding, masked by slot_valid)
        C = buf.frame_avg_loss.shape[0]
        rows = idxs.clamp(max=C - 1) if C < Wn else idxs
        if cfg.do_active:
            ib, ih, iw = S.sample_pixels_active(
                gen, n_rays, Wn, H, W, buf.loss_approx[rows],
                cfg.active_frac)
        else:
            ib, ih, iw = S.sample_pixels(gen, n_rays, Wn, H, W, dev)
        gi = rows[ib]
        depth = buf.depth[gi, ih, iw]
        valid = (depth != 0.0) & slot_valid[ib]
        if cfg.do_normal:
            normals = buf.normals[gi, ih, iw]
            valid &= ~torch.isnan(normals[..., 0])
            normals = torch.nan_to_num(normals)
        else:
            normals = torch.zeros((depth.shape[0], 3), device=dev)
        depth_safe = torch.where(valid, depth, 1.0)
        dirs_C = self.dirs[ih, iw]
        pc, z_vals, _, dirs_W = S.sample_along_rays(
            gen, buf.T_WC[gi], dirs_C, depth_safe, cfg.min_depth,
            cfg.dist_behind_surf, cfg.n_strat_samples, cfg.n_surf_samples)
        noise = torch.randn(pc.shape[0] * pc.shape[1], generator=gen,
                            device=dev) * noise_std
        surf = sv = None
        if cfg.bounds_method == "pc":
            surf, sv = self.surf_set(gen, pc, valid)
        scalars, ploss, grads = self.loss_and_grad(
            params, transform, pc, z_vals, dirs_C, dirs_W, depth_safe,
            normals, valid, noise, surf=surf, sv=sv)
        self.update(params, opt_state, buf, grads, ploss, idxs, slot_valid,
                    ib, ih, iw, valid, lr_scale)
        return scalars

    @torch.no_grad()
    def train_bundle(self, params, opt_state, buf: FrameBuffer, transform,
                     seed: int, noise_std: float, n_steps: int = 1,
                     lr_scale: float = 1.0, tail: bool = False,
                     step0: int = 0) -> Dict[str, torch.Tensor]:
        """Run n_steps steps in place; returns the per-step scalars stacked
        [n_steps] on the device. Step step0 + t draws from self.gen seeded
        with step_seed(seed, step0 + t). Traced, the call is the span
        ``step.bundle`` (utils/profiling.py): the interval the sim clock
        bills, with the train op's ``bundle_counts``."""
        if self.k1_mode and "blocks_per_sm" not in self.bundle_counts:
            self.bundle_counts["blocks_per_sm"] = blocks_per_sm(
                self.k1_mode, self.model, self.device)
        with span("step.bundle", steps=n_steps, **self.bundle_counts):
            with span("step.table"):
                table = step_table(n_steps, noise_std, lr_scale, buf.count,
                                   self.device)
            tail = bool(tail)
            if not self.eager:
                return self._graph_bundle(params, opt_state, buf, transform,
                                          seed, table, n_steps, tail, step0)
            out = []
            for t in range(n_steps):
                with span("step.eager"):
                    self.gen.manual_seed(step_seed(seed, step0 + t))
                    out.append(self.core(params, opt_state, buf, transform,
                                         self.gen, table[t], tail))
            return {k: torch.stack([o[k] for o in out]) for k in out[0]}

    def graph_key(self, buf: FrameBuffer, tail: bool):
        """What a captured step bakes in from the host: select_window's
        branch (count <= window), the refinement tail, and, where the arena
        is smaller than the window, the fill count (the write-back slices
        by it)."""
        Wn = self.cfg.window_size
        return (buf.count <= Wn, bool(tail),
                buf.count if buf.capacity < Wn else None)

    def _graph_bundle(self, params, opt_state, buf, transform, seed, table,
                      n_steps, tail, step0):
        from isdf_tpu_torch.utils import graphs as G
        on = G.captured_on(
            [params[k] for k in sorted(params)] + [opt_state["count"]]
            + [opt_state[m][k] for m in ("mu", "nu")
               for k in sorted(opt_state[m])]
            + [buf.depth, buf.T_WC, buf.normals, buf.frame_avg_loss,
               buf.loss_approx, transform], transform)
        if not G.same_inputs(on, self._captured_on):
            # new tensors (a checkpoint load) or an edited transform: the
            # graphs would read stale addresses
            self._captured.clear()
            self._captured_on = on
        if self.graphs is None:
            self.graphs = G.GraphRunner(self.device)
        key = self.graph_key(buf, tail)
        rows, t0 = [], 0
        if key not in self._captured:
            def first():
                self.gen.manual_seed(step_seed(seed, step0))
                sc = self.core(params, opt_state, buf, transform, self.gen,
                               table[0], tail)
                return sorted(sc), torch.stack([sc[k] for k in sorted(sc)])
            names, row = self.graphs.warm(first)
            rows.append(row)
            ins = torch.zeros(3, device=self.device)
            out = torch.zeros(len(names), device=self.device)

            def step():
                sc = self.core(params, opt_state, buf, transform, self.gen,
                               ins, tail)
                out.copy_(torch.stack([sc[k] for k in names]))
            graph = self.graphs.capture(step, generators=(self.gen,))
            self._captured[key] = (graph, ins, out, names)
            t0 = 1
        graph, ins, out, names = self._captured[key]
        for t in range(t0, n_steps):
            with span("step.replay"):
                self.gen.manual_seed(step_seed(seed, step0 + t))
                ins.copy_(table[t])
                graph.replay()
                rows.append(out.clone())
        stacked = torch.stack(rows)
        return {k: stacked[:, i] for i, k in enumerate(names)}

    # ---------------- keyframe decision ----------------
    @torch.no_grad()
    def is_keyframe(self, params, depth_img, T_WC, transform, gen,
                    noise_std: float):
        """Render the candidate frame through the frozen net and test the
        fraction of rays whose relative depth error is under threshold
        (reference trainer.py:586-620; noise on during the check).
        Returns (is_keyframe, below-threshold proportion)."""
        cfg = self.cfg
        ib, ih, iw = S.sample_pixels(gen, cfg.n_rays_is_kf, 1, self.H,
                                     self.W, self.device)
        depth = depth_img[ih, iw]
        valid = depth != 0.0
        depth_safe = torch.where(valid, depth, 1.0)
        T = T_WC.expand(depth.shape[0], 4, 4)
        pc, z_vals, _, _ = S.sample_along_rays(
            gen, T, self.dirs[ih, iw], depth_safe, cfg.min_depth,
            0.8,  # the reference hard-codes dist_behind_surf=0.8 here
            cfg.n_strat_samples, cfg.n_surf_samples)
        sdf = M.apply_with_noise(params, pc, self.model, gen, noise_std,
                                 transform=transform)
        z_sorted, sdf_sorted = R.sort_by_z(z_vals, sdf)
        view_depth = R.sdf_render_depth(z_sorted, sdf_sorted)
        err = (view_depth - depth_safe).abs() / depth_safe
        below = (err < cfg.kf_dist_th) & valid
        with span("trainer.kf_fetch"):   # the check's syncs
            prop = float(below.sum()) / max(int(valid.sum()), 1)
        return prop < cfg.kf_pixel_ratio, prop

    # ---------------- queries ----------------
    @torch.no_grad()
    def eval_sdf(self, params, pts, transform):
        return M.apply(params, pts, self.model, transform=transform)

    def eval_sdf_grad(self, params, pts, transform):
        return M.sdf_and_grad(params, pts, self.model, transform=transform)[1]

    @torch.no_grad()
    def render_depth(self, params, T_WC, dirs_C, gt_depth, transform, gen,
                     n_strat: int = 40, draws=None):
        """Depth along given rays by dense stratified sampling and the
        first sign crossing (isdf_tpu step.py:583-597): T_WC [F, 4, 4],
        dirs_C [F, N, 3], gt_depth [F, N] bounds the range like the
        training sampler, with no surface samples. ``draws``: the
        stratified uniforms [F * N, n_strat] (tests). -> depth [F, N]."""
        F, N, _ = dirs_C.shape
        Tb = T_WC.repeat_interleave(N, dim=0)
        pc, z_vals, _, _ = S.sample_along_rays(
            gen, Tb, dirs_C.reshape(F * N, 3), gt_depth.reshape(F * N),
            self.cfg.min_depth, self.cfg.dist_behind_surf, n_strat, 0,
            draws=None if draws is None else (draws, None))
        sdf = M.apply(params, pc, self.model, transform=transform)
        z_sorted, sdf_sorted = R.sort_by_z(z_vals, sdf)
        return R.sdf_render_depth(z_sorted, sdf_sorted).reshape(F, N)
