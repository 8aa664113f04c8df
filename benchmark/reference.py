"""The plain reference of the benchmark's comparisons: iSDF's map and its
training step in plain PyTorch, written from the paper's equations and
the reference code's conventions (facebookresearch/iSDF, RSS 2022).

It imports nothing of the program and takes nothing the program made: it
gets the benchmark's own inputs (weights in the per-layer layout, depth
views, poses, seeds) and recomputes everything else (normals, priorities,
the scene frame).

* ``sdf`` / ``sdf_and_grad``: the icosahedron positional encoding, the
  softplus(100) MLP with its skip concat, the spatial gradient by autograd.
* ``RefStep``: the online trainer's step as iSDF defines it: the window
  (the two newest keyframes plus three drawn by loss, Gumbel top-k), the
  active pixel draw over 8 x 8 loss blocks, the samples along each ray,
  the output noise, the batch-distance ("pc") or ray bounds, the free-space,
  truncation, gradient-cosine and gated eikonal losses, AdamW and the
  priority write-back. Its random draws are made by torch's generator on
  the card from the same per-step seeds, call for call, as iSDF's
  sampler makes them, so both sides see the same pixels and samples.

``prec`` sets the operand precision of the hidden layers' products:
"f32" (IEEE, TF32 off: the query path's), "tf32" (operands rounded to
TF32's 10 mantissa bits: the control one step below it), "bf16"
(operands rounded to bfloat16, float32 sums: the shipped configs'
``mm_precision: default``) or "fp8" (operands scaled per tensor into
float8 e4m3 and back: the control one step below bf16).
The gradients flowing back through a product are rounded alike.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MASK64 = (1 << 64) - 1

ICOSA = np.array([
    [0.8506508, 0.0, 0.5257311], [0.809017, 0.5, 0.309017],
    [0.5257311, 0.8506508, 0.0], [1.0, 0.0, 0.0],
    [0.809017, 0.5, -0.309017], [0.8506508, 0.0, -0.5257311],
    [0.309017, 0.809017, -0.5], [0.0, 0.5257311, -0.8506508],
    [0.5, 0.309017, -0.809017], [0.0, 1.0, 0.0],
    [-0.5257311, 0.8506508, 0.0], [-0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, 0.8506508], [-0.309017, 0.809017, 0.5],
    [0.309017, 0.809017, 0.5], [0.5, 0.309017, 0.809017],
    [0.5, -0.309017, 0.809017], [0.0, 0.0, 1.0],
    [-0.5, 0.309017, 0.809017], [-0.809017, 0.5, 0.309017],
    [-0.809017, 0.5, -0.309017]], dtype=np.float32)


def _round(x, prec: str):
    if prec == "tf32":   # 10 mantissa bits, rounded to nearest
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    if prec == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if prec == "fp8":
        amax = x.detach().abs().amax().clamp(min=1e-30)
        s = 448.0 / amax
        return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x


class _Q(torch.autograd.Function):
    """Rounds the operand to ``prec`` and, going back, its gradient."""

    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return _round(x, prec)

    @staticmethod
    def backward(ctx, g):
        return _Q.apply(g, ctx.prec), None


def q(x, prec: str):
    return x if prec == "f32" else _Q.apply(x, prec)


# ---------------------------------------------------------------------------
# the map
# ---------------------------------------------------------------------------

class Map:
    """The SDF MLP's hyper-parameters, from a reference-schema config."""

    def __init__(self, cfg: dict):
        m = cfg["model"]
        self.n_freqs = int(m["embedding"]["n_embed_funcs"]) + 1
        self.E = 2 * 21 * self.n_freqs + 3
        self.H = int(m["hidden_feature_size"])
        self.blocks = int(m["hidden_layers_block"])
        self.scale_input = float(np.float32(m["embedding"]["scale_input"]))
        self.scale_output = float(m["scale_output"])

    @property
    def n_layers(self) -> int:
        return 2 * self.blocks + 3


def encode(x, transform, mp: Map):
    """Icosahedron PE of world points x [..., 3]: [xs, sin(xs.d 2^k),
    sin(xs.d 2^k + pi/2)], xs the scene-frame point times scale_input."""
    xs = (x @ transform[:3, :3].T + transform[:3, 3]) * mp.scale_input
    D = torch.as_tensor(ICOSA.T.copy(), device=x.device).to(x.dtype)
    bands = torch.as_tensor(2.0 ** np.linspace(0, mp.n_freqs - 1, mp.n_freqs)
                            .astype(np.float32), device=x.device).to(x.dtype)
    xb = ((xs @ D)[..., None] * bands).reshape(*xs.shape[:-1], -1)
    return torch.cat([xs, torch.sin(torch.cat([xb, xb + 0.5 * np.pi], -1))],
                     dim=-1)


class _Softplus100(torch.autograd.Function):
    """log(1 + exp(100 x)) / 100 in the stable form max(z, 0) +
    log1p(exp(-|z|)) over 100 (iSDF fc_map.py:51-55), with the derivative
    autograd takes of that form written out: sigmoid(100 x), and 1 at
    x = 0, where clamp passes the gradient and abs's is 0. Written out,
    its own derivative goes through sigmoid natively (through abs autograd
    calls a decomposition that loads torch._dynamo, seconds of set-up)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        z = 100.0 * x
        return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))) \
            * 0.01

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.where(x == 0, 1.0, torch.sigmoid(100.0 * x))


def softplus100(x):
    return _Softplus100.apply(x)


def sdf(layers, x, transform, mp: Map, prec: str = "f32"):
    """SDF at world points x [..., 3]: hidden products at ``prec``, the
    output head in float32."""
    pe = encode(x, transform, mp)
    h = pe
    for i, (w, b) in enumerate(layers[:-1]):
        if i == mp.blocks + 1:
            h = torch.cat([h, pe], dim=-1)
        h = softplus100(q(h, prec) @ q(w, prec) + b)
    w, b = layers[-1]
    return (h @ w + b)[..., 0] * mp.scale_output


def sdf_and_grad(layers, x, transform, mp: Map, prec: str = "f32",
                 create_graph: bool = False):
    """(sdf [...], d sdf / dx [..., 3])."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        s = sdf(layers, xg, transform, mp, prec)
        (g,) = torch.autograd.grad(s.sum(), xg, create_graph=create_graph)
    return s, g


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def normals_from_depth(depth, fx, fy, cx, cy, d: int = 2):
    """Normals of a depth view [H, W] from the best of the 8 neighbour
    pairs at distance d (iSDF transform.py:215-270); NaN where the depth
    is 0 or no valid pair exists."""
    H, W = depth.shape
    dep = torch.where(depth == 0.0, torch.nan, depth)
    c = torch.arange(W, dtype=dep.dtype, device=dep.device)[None, :]
    r = torch.arange(H, dtype=dep.dtype, device=dep.device)[:, None]
    p = torch.stack((dep * (c - cx) / fx, dep * (r - cy) / fy, dep), dim=-1)
    pad = torch.full((H + 2 * d, W + 2 * d, 3), float("nan"),
                     dtype=p.dtype, device=p.device)
    pad[d:-d, d:-d] = p
    offs = [(-d, 0), (-d, d), (0, d), (d, d), (d, 0), (d, -d), (0, -d),
            (-d, -d)]

    def sh(o):
        return pad[d + o[0]:d + o[0] + H, d + o[1]:d + o[1] + W]

    p2s = torch.stack([sh(offs[k]) for k in range(8)])
    p3s = torch.stack([sh(offs[(k + 2) % 8]) for k in range(8)])
    dist = (p2s - p[None]).norm(dim=-1) + (p3s - p[None]).norm(dim=-1)
    dist = torch.where(torch.isnan(dist), torch.inf, dist)
    k = dist.argmin(dim=0)[None, ..., None].expand(1, H, W, 3)
    p2 = torch.gather(p2s, 0, k)[0]
    p3 = torch.gather(p3s, 0, k)[0]
    n = torch.linalg.cross(p2 - p, p3 - p)
    return n / n.norm(dim=-1, keepdim=True)


def oriented_bounds(points):
    """The PCA box of a point set [N, 3] (float64): (T_scene_to_box, the
    box's extents), the contract of trimesh.bounds.oriented_bounds that
    iSDF's trainer uses for the training domain (trainer.py:121-122)."""
    pts = np.asarray(points, dtype=np.float64)
    c = pts.mean(axis=0)
    _, R = np.linalg.eigh(np.cov((pts - c).T))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    local = (pts - c) @ R
    lo, hi = local.min(axis=0), local.max(axis=0)
    mid = c + R @ ((hi + lo) / 2.0)
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ mid
    return T, hi - lo


def scene_transform(obj_path: str) -> np.ndarray:
    """The world -> unit-box transform [4, 4] float32 of a scene mesh's
    PCA box, read from the OBJ's vertices as float32."""
    with open(obj_path) as f:
        v = np.asarray([[float(x) for x in ln.split()[1:4]] for ln in f
                        if ln.startswith("v ")], np.float32)
    T, _ = oriented_bounds(v)
    box_to_world = np.linalg.inv(T).astype(np.float32)
    return np.linalg.inv(box_to_world).astype(np.float32)


def step_seed(seed: int, step: int) -> int:
    """splitmix64 of (seed, step): the generator seed of one global step."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def gumbel(gen, shape, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def cos_sim(a, b, eps: float = 1e-6):
    return (a * b).sum(-1) / (a.norm(dim=-1).clamp(min=eps)
                              * b.norm(dim=-1).clamp(min=eps))


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    n = m.sum()
    return torch.where(n > 0, (x * m).sum() / n.clamp(min=1.0), 0.0)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

class RefStep:
    """iSDF's online step over an arena of keyframes, from the benchmark's
    inputs: ``layers`` the initial weights [(w, b)], ``depth`` [n, H, W]
    and ``poses`` [n, 4, 4] the n keyframes in the arena's order (on the
    device), ``capacity`` the arena's rows (n where not given), ``cam``
    the camera, ``seed`` the trainer's seed. ``half_batch`` leaves out
    every other ray of each step, the mean taken over the rest (a fault
    the comparison must catch)."""

    def __init__(self, cfg: dict, layers, depth, poses, cam: dict,
                 transform, seed: int, prec: str = "bf16",
                 half_batch: bool = False, capacity: int = None):
        mp = self.mp = Map(cfg)
        s, lo, mo = cfg["sample"], cfg["loss"], cfg["model"]
        self.n_rays, self.window = int(s["n_rays"]), int(mo["window_size"])
        self.n_strat, self.n_surf = (int(s["n_strat_samples"]),
                                     int(s["n_surf_samples"]))
        self.min_depth = float(s["depth_range"][0])
        self.behind = float(s["dist_behind_surf"])
        self.bounds = lo["bounds_method"]
        self.trunc_d, self.trunc_w = (float(lo["trunc_distance"]),
                                      float(lo["trunc_weight"]))
        self.eik_w, self.eik_d = float(lo["eik_weight"]), float(
            lo["eik_apply_dist"])
        self.grad_w = float(lo["grad_weight"])
        self.active = bool(mo["do_active"])
        self.active_frac = float(mo.get("active_frac", 0.5))
        self.noise_std = float(mo["noise_frame"])
        self.lr = float(cfg["optimiser"]["lr"])
        self.wd = float(cfg["optimiser"]["weight_decay"])
        self.surf_budget = int(cfg.get("tpu", {}).get("pc_surf_budget", 1000))
        self.prec, self.half = prec, half_batch
        dev = depth.device
        self.dev = dev
        self.layers = [(w.detach().clone(), b.detach().clone())
                       for w, b in layers]
        self.m = [(torch.zeros_like(w), torch.zeros_like(b))
                  for w, b in self.layers]
        self.v = [(torch.zeros_like(w), torch.zeros_like(b))
                  for w, b in self.layers]
        self.t = 0
        self.depth, self.poses = depth, poses
        C, H, W = depth.shape
        self.count, self.cap = C, capacity or C
        self.H, self.W = H, W
        self.cam = cam
        self._normals = {}
        self.dirs = ray_dirs(H, W, cam, dev)
        self.transform = transform
        self.frame_avg = torch.zeros(self.cap, device=dev)
        self.loss_grid = torch.zeros((self.cap, 8, 8), device=dev)
        self.bundle_seed = step_seed(seed, 0x5DF)
        self.gen = torch.Generator(device=dev)

    def draw(self, t: int, frame_avg=None, loss_grid=None):
        """Step t's window and pixels -> (idxs, slot_ok, ib, ih, iw), drawn
        over the reference's priorities or the given ones; leaves the
        generator where the ray samples' draws begin."""
        frame_avg = self.frame_avg if frame_avg is None else frame_avg
        loss_grid = self.loss_grid if loss_grid is None else loss_grid
        gen, dev = self.gen, self.dev
        gen.manual_seed(step_seed(self.bundle_seed, t))
        C, n = frame_avg.shape[0], self.count
        Wn, nr, H, W = self.window, self.n_rays, self.H, self.W
        g = gumbel(gen, (C,), dev)
        if n <= Wn:
            idxs = torch.arange(Wn, device=dev)
            slot_ok = idxs < n
            if C < Wn:
                idxs = idxs.clamp(max=C - 1)
        else:
            pos = torch.arange(C, device=dev)
            logit = torch.where(pos < n - 2,
                                torch.log(frame_avg.clamp(min=1e-30)),
                                -torch.inf)
            top = torch.topk(logit + g, Wn - 2).indices
            idxs = torch.cat([top, torch.arange(2, device=dev) + (n - 2)])
            slot_ok = torch.ones(Wn, dtype=torch.bool, device=dev)
        T = nr * Wn
        ib = torch.arange(Wn, device=dev).repeat_interleave(nr)
        if self.active:
            hb, wb = H // 8, W // 8
            ih_u = torch.randint(0, H, (T,), generator=gen, device=dev)
            iw_u = torch.randint(0, W, (T,), generator=gen, device=dev)
            gg = gumbel(gen, (Wn, nr, 64), dev)
            off = torch.randint(0, max(hb, wb), (2, T), generator=gen,
                                device=dev)
            logw = torch.log(loss_grid[idxs].reshape(Wn, 64)
                             .clamp(min=1e-12))
            blk = (logw[:, None, :] + gg).argmax(-1).reshape(T)
            ih_a = torch.clamp((blk // 8) * hb + off[0] % hb, max=H - 1)
            iw_a = torch.clamp((blk % 8) * wb + off[1] % wb, max=W - 1)
            act = (torch.arange(T, device=dev) % nr) < round(
                nr * self.active_frac)
            ih = torch.where(act, ih_a, ih_u)
            iw = torch.where(act, iw_a, iw_u)
        else:
            ih = torch.randint(0, H, (T,), generator=gen, device=dev)
            iw = torch.randint(0, W, (T,), generator=gen, device=dev)
        return idxs, slot_ok, ib, ih, iw

    def normals_at(self, fr, ih, iw) -> torch.Tensor:
        """The normals [T, 3] of view ``fr`` at pixel (ih, iw) of each ray,
        a view's normals computed once, when a step first reads it."""
        cam = self.cam
        out = torch.zeros(fr.shape + (3,), device=self.dev)
        for r in sorted(set(fr.tolist())):
            if r not in self._normals:
                self._normals[r] = normals_from_depth(
                    self.depth[r], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
            m = fr == r
            out[m] = self._normals[r][ih[m], iw[m]]
        return out

    def rays_apart(self, t: int, frame_avg, loss_grid) -> int:
        """How many of step t's rays land on another pixel when drawn over
        the given priorities (the program's) instead of the reference's."""
        a = self.draw(t)
        b = self.draw(t, frame_avg, loss_grid)
        fa, fb = a[0][a[2]], b[0][b[2]]
        return int(((fa != fb) | (a[3] != b[3]) | (a[4] != b[4])).sum())

    def grads_of(self, t: int):
        """Draw step t's batch and return (total loss, per-sample loss
        [R, S], gradients [(dw, db)], the batch's bookkeeping)."""
        gen, dev = self.gen, self.dev
        idxs, slot_ok, ib, ih, iw = self.draw(t)
        T = ib.shape[0]
        fr = idxs[ib].clamp(max=self.count - 1)   # empty rows: masked
        depth = self.depth[fr, ih, iw]
        nrm = self.normals_at(fr, ih, iw)
        valid = (depth != 0.0) & slot_ok[ib] & ~torch.isnan(nrm[..., 0])
        nrm = torch.nan_to_num(nrm)
        depth = torch.where(valid, depth, 1.0)
        Twc = self.poses[fr]
        dirs_C = self.dirs[ih, iw]
        dirs_W = (Twc[:, :3, :3] @ dirs_C[..., None])[..., 0]
        u = torch.rand((T, self.n_strat), generator=gen, device=dev)
        nz = torch.randn((T, self.n_surf - 1), generator=gen, device=dev)
        far = depth + self.behind
        lims = torch.linspace(0.0, 1.0, self.n_strat + 1, device=dev)[None]
        span = (far - self.min_depth)[:, None]
        strat = lims[:, :-1] * span + self.min_depth + u * (span / self.n_strat)
        near = torch.minimum(torch.clamp(depth[:, None] + 0.1 * nz,
                                         min=self.min_depth), far[:, None])
        z = torch.cat([depth[:, None], near, strat], dim=1)
        pc = Twc[:, None, :3, 3] + dirs_W[:, None, :] * z[..., None]
        R, S = z.shape
        noise = torch.randn(R * S, generator=gen, device=dev) * self.noise_std
        if self.bounds == "pc" and self.surf_budget < R:
            raise NotImplementedError("surface subsampling")
        if self.half:    # every other ray left out
            valid = valid & (torch.arange(T, device=dev) % 2 == 0)
        leaves = [(w.detach().requires_grad_(True),
                   b.detach().requires_grad_(True)) for w, b in self.layers]
        with torch.enable_grad():
            xg = pc.detach().requires_grad_(True)
            s = sdf(leaves, xg, self.transform, self.mp, self.prec)
            (sg,) = torch.autograd.grad(s.sum(), xg, create_graph=True)
            s = s + noise.reshape(R, S) * self.mp.scale_output
            b, gvec, gok = self._bounds(pc, z, depth, dirs_C, dirs_W, valid)
            free = b > self.trunc_d
            fs = torch.maximum(torch.relu(s - b), torch.exp(-5.0 * s) - 1.0)
            mat = torch.where(free, fs, s - b).abs()
            mat = torch.where(free, mat, mat * self.trunc_w)
            vm = valid[:, None].expand(R, S)
            tot = mat
            if self.grad_w != 0:
                gv = gvec if gok is None else torch.where(
                    gok[..., None], gvec, nrm[:, None, :])
                gl = torch.cat([(1.0 - cos_sim(sg[:, 0], nrm))[:, None],
                                1.0 - cos_sim(gv, sg[:, 1:])], dim=1)
                tot = tot + self.grad_w * gl
            if self.eik_w != 0:
                eik = torch.where(b < self.eik_d, 0.0,
                                  (sg.norm(dim=-1) - 1.0).abs()) * self.eik_w
                tot = tot + eik
            tot = tot * valid[:, None].float()
            total = masked_mean(tot, vm)
            flat = [p for wb in leaves for p in wb]
            grads = torch.autograd.grad(total, flat)
        grads = [(grads[2 * i], grads[2 * i + 1]) for i in range(len(leaves))]
        return (total.detach(), tot.detach(), grads,
                (idxs, slot_ok, ib, ih, iw, valid))

    def _bounds(self, pc, z, depth, dirs_C, dirs_W, valid):
        R, S, _ = pc.shape
        if self.bounds == "ray":
            b = (depth[:, None] - z) * dirs_C.norm(dim=-1)[:, None]
            return b, (-dirs_W[:, None, :]).expand(R, S - 1, 3), None
        surf = pc[:, 0]
        flat = pc.reshape(R * S, 3)
        score = -2.0 * (flat @ surf.T) + (surf * surf).sum(-1)[None]
        score = torch.where(valid[None, :], score, torch.inf)
        diff = flat - surf[score.argmin(-1)]
        dist = diff.norm(dim=-1).reshape(R, S)
        behind = z > depth[:, None]
        b = torch.where(behind, -dist, dist)
        d3 = diff.reshape(R, S, 3)[:, 1:]
        n = d3.norm(dim=-1, keepdim=True)
        g = d3 / n.clamp(min=1e-12)
        return b, torch.where(behind[:, 1:, None], -g, g), n[..., 0] > 0

    def step(self, t: int) -> float:
        """Step t in place (AdamW, then the priority write-back); returns
        its total loss."""
        total, tot, grads, (idxs, slot_ok, ib, ih, iw, valid) = \
            self.grads_of(t)
        self.t += 1
        c1 = 1.0 / (1.0 - 0.9 ** self.t)
        c2 = 1.0 / (1.0 - 0.999 ** self.t)
        new = []
        for (w, b), (mw, mb), (vw, vb), (gw, gb) in zip(
                self.layers, self.m, self.v, grads):
            out = []
            for p, m, v, g in ((w, mw, vw, gw), (b, mb, vb, gb)):
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.999).add_(0.001 * g * g)
                out.append(p - self.lr * ((m * c1) / (torch.sqrt(v * c2)
                                                      + 1e-8) + self.wd * p))
            new.append(tuple(out))
        self.layers = new
        self._write_back(tot.sum(-1), valid, idxs, slot_ok, ib, ih, iw)
        return float(total)

    def _write_back(self, ray_loss, valid, idxs, slot_ok, ib, ih, iw):
        """Per-frame 8 x 8 block means of the ray losses (iSDF
        loss.py:208-240) into the arena's priorities."""
        Wn, H, W, dev = self.window, self.H, self.W, self.dev
        blk = (ib * 64 + (ih // (H // 8)).clamp(0, 7) * 8
               + (iw // (W // 8)).clamp(0, 7))
        w = valid.float()
        sums = torch.zeros(Wn * 64, dtype=torch.float64, device=dev)
        cnt = torch.zeros(Wn * 64, dtype=torch.float64, device=dev)
        sums.index_add_(0, blk, (ray_loss * w).double())
        cnt.index_add_(0, blk, w.double())
        grid = (sums / cnt.clamp(min=1.0)).float().reshape(Wn, 8, 8)
        avg = grid.sum(dim=(1, 2)) / 64.0
        C = self.frame_avg.shape[0]
        rows = idxs.clamp(max=C - 1)
        s = torch.zeros(C, device=dev).index_add_(
            0, rows, torch.where(slot_ok, avg, 0.0))
        n = torch.zeros(C, device=dev).index_add_(0, rows, slot_ok.float())
        self.frame_avg = torch.where(n > 0, s / n.clamp(min=1.0),
                                     self.frame_avg)
        keep = self.loss_grid[rows]
        self.loss_grid[rows] = torch.where(slot_ok[:, None, None], grid, keep)


def ray_dirs(H, W, cam, device):
    c = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    r = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    return torch.stack((((c - cam["cx"]) / cam["fx"]).expand(H, W),
                        ((r - cam["cy"]) / cam["fy"]).expand(H, W),
                        torch.ones((H, W), device=device)), dim=-1)


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------

def leaf_norm_gaps(prog: Sequence[torch.Tensor],
                   ref: Sequence[torch.Tensor],
                   ref_grad: Sequence[torch.Tensor] = None) -> List[float]:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's. Leaves whose reference
    gradient ``ref_grad`` is under a thousandth of the median leaf's are
    left out (their moves are round-off under Adam)."""
    pn = [float(p.double().norm()) for p in prog]
    rn = [float(r.double().norm()) for r in ref]
    keep = list(range(len(rn)))
    if ref_grad is not None:
        gn = [float(g.double().norm()) for g in ref_grad]
        gmed = float(np.median(gn))
        keep = [i for i in keep if gn[i] >= 1e-3 * gmed]
    med = float(np.median([rn[i] for i in keep]))
    return [abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in keep]


def flat_leaves(layers) -> List[torch.Tensor]:
    return [p for wb in layers for p in wb]


def compare_first_steps(ref: RefStep, prog_losses: Sequence[float],
                        prog_grad0, prog_delta) -> Dict[str, float]:
    """Run the reference's first len(prog_losses) steps and hold the
    program's readings against them: each step's loss, the first step's
    gradient (as the optimiser got it) and the change of the parameters
    over the steps, leaf by leaf (per-layer (w, b) lists)."""
    start = [(w.clone(), b.clone()) for w, b in ref.layers]
    _, _, g0, _ = ref.grads_of(0)
    losses = [ref.step(t) for t in range(len(prog_losses))]
    delta = [(w1 - w0, b1 - b0) for (w1, b1), (w0, b0)
             in zip(ref.layers, start)]
    g0f = flat_leaves(g0)
    grad = leaf_norm_gaps(flat_leaves(prog_grad0), g0f)
    change = leaf_norm_gaps(flat_leaves(prog_delta), flat_leaves(delta), g0f)
    return {
        "loss_rel": max(abs(p - r) / max(abs(r), 1e-30)
                        for p, r in zip(prog_losses, losses)),
        "loss1_rel": abs(prog_losses[0] - losses[0]) / max(abs(losses[0]),
                                                          1e-30),
        "grad1_gap": max(grad),
        "change_gap": max(change),
        "change_med": float(np.median(change)),
        "worst_change_leaf": int(np.argmax(change)),
        "leaves_left_out": len(g0f) - len(change),
    }


def query_gaps(layers, mp: Map, transform, pts, sdf_prog, grad_prog,
               prec: str = "f32", block: int = 1 << 16):
    """The worst gaps of a sample of answered queries: |sdf - ref| over
    the largest |ref| and |grad - ref| over the largest |ref grad|, the
    reference recomputed at ``prec`` in blocks."""
    s_err = g_err = 0.0
    s_max = g_max = 0.0
    for i in range(0, pts.shape[0], block):
        x = pts[i:i + block]
        if grad_prog is None:
            with torch.no_grad():
                r = sdf(layers, x, transform, mp, prec)
            s_err = max(s_err, float((sdf_prog[i:i + block] - r).abs().max()))
            s_max = max(s_max, float(r.abs().max()))
        else:
            _, r = sdf_and_grad(layers, x, transform, mp, prec)
            g_err = max(g_err, float((grad_prog[i:i + block] - r).abs().max()))
            g_max = max(g_max, float(r.abs().max()))
    return s_err / max(s_max, 1e-30), g_err / max(g_max, 1e-30)
