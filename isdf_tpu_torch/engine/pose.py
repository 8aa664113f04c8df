"""Pose refinement: an SE(3) correction per keyframe by SDF tracking
(isdf_tpu/engine/pose.py).

The reference carries a ``pose_refine`` config section (pose_lr,
replicaCAD.json:81-83) but ships the feature off. As in isdf_tpu, the
correction T_WC' = exp(xi) T_WC of a frame is solved by damped
Gauss-Newton against the current map (KinectFusion-style SDF tracking) and
run by the loop on each ingested frame with ``model.refine_poses``.

A burst is split in two: ``PoseRefiner.draw`` draws its sample set (pixels
and depth offsets along their rays) and ``PoseRefiner.solve`` runs the
Levenberg-Marquardt iterations on a given sample set. isdf_tpu's burst is
one jitted ``lax.scan``; here it is a Python loop whose accept / reject is
``torch.where`` on device tensors, never a branch on a device value, and
nothing waits on the host: isdf_tpu's eigendecomposition (whose error
check would) gives way to what the step needs of it, the largest
eigenvalue (``top_eigenvalue``) and the damped solve (``spd_solve``), in
fixed-shape torch ops. On the card a burst is captured as a CUDA graph per
(frames, iterations) and replayed (utils/graphs.py), its first call of a
shape eager; ``eager=True`` keeps every call eager. Pose math is float32
(TF32 is off in the whole port). The per-frame sums of the normal
equations and the twist update add in a fixed order (``segment_sum``), so
a burst gives the same bits on every run."""

from __future__ import annotations

import dataclasses

import torch

from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.ops import geometry as G
from isdf_tpu_torch.ops import sampling as S


@dataclasses.dataclass
class PoseState:
    twists: torch.Tensor    # [C, 6] per arena row: (omega, v)


def init_pose_state(capacity: int, pose_lr: float = 4e-4, device="cpu"):
    """(state, None). pose_lr is kept for the reference schema; the GN
    solver has no learning rate."""
    del pose_lr
    return PoseState(torch.zeros((capacity, 6), device=device)), None


def segment_onehot(seg, n: int):
    """The one-hot [n, R] f32 matrix of segment ids ``seg`` [R] in [0, n)."""
    return (seg[None, :] == torch.arange(n, device=seg.device)[:, None]
            ).float()


def segment_sum(v, onehot):
    """Sums of the rows of ``v`` [R, ...] by segment into [n, ...]
    (jax.ops.segment_sum), ``onehot`` = segment_onehot(seg, n): their
    product, which adds in a fixed order, the same bits in every run (f32
    products; the package turns TF32 off). On the card index_add_ adds
    with atomics in an order that varies from run to run. A burst builds
    its one-hot matrices once; its n (frames, or arena rows) is small."""
    n = onehot.shape[0]
    return (onehot @ v.reshape(v.shape[0], -1)).reshape((n,) + v.shape[1:])


def top_eigenvalue(A, squarings: int = 20):
    """The largest eigenvalue [F] of symmetric positive semi-definite
    matrices A [F, n, n] (torch.linalg.eigh's last): P = A / tr(A) squared
    and renormalised to trace 1 ``squarings`` times tends to the projector
    onto the top eigenspace over its dimension, and tr(A P) to the top
    eigenvalue: each other eigenvalue e_i adds a relative error of at most
    g (1 - g)^(2^squarings) < 1 / (e 2^squarings), g its relative gap,
    whatever g is (1.8e-6 for all five others of a 6 x 6 matrix at 20
    squarings). A zero matrix gives 0."""
    def normed(P):
        tr = P.diagonal(dim1=-2, dim2=-1).sum(-1)
        return P / tr.clamp(min=1e-30)[:, None, None]

    P = normed(A)
    for _ in range(squarings):
        P = normed(P @ P)
    return (A * P).sum(dim=(1, 2))


def spd_solve(A, b):
    """x [F, n] with A x = b for symmetric positive definite A [F, n, n]:
    Gauss-Jordan elimination, no pivoting (positive definite pivots need
    none), in fixed-shape torch ops."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)                 # [F, n, n+1]
    for k in range(n):
        piv = M[:, k:k + 1] / M[:, k:k + 1, k:k + 1]
        M = M - M[:, :, k:k + 1] * piv
        M[:, k:k + 1] = piv
    return M[:, :, n]


def corrected_poses(twists, T_WC):
    """exp(xi) applied on the left of each pose."""
    return G.exp_se3(twists) @ T_WC


class PoseRefiner:
    """Damped Gauss-Newton on a fixed per-burst sample set (isdf_tpu
    pose.py::build_pose_refine_step): residual r_i = sdf(x_i) at surface
    samples x_i of the selected frames through their corrected poses,
    Jacobian J_i = [(x_i - c) x grad_i, grad_i] about the camera centre c,
    (J^T W J + lam I) delta = -J^T W r per frame, with lam relative to the
    largest eigenvalue, a 5 cm / 0.05 rad trust region and an LM accept on
    the truncated mean |sdf|. The map is frozen.

    ``sdf_gate``: samples whose |sdf| exceeds it, or whose |grad| lies
    outside (0.5, 1.5) (untrained space), are not inliers. ``eager``: no
    CUDA graphs on the card."""

    def __init__(self, model: M.SDFModel, n_rays: int = 200,
                 n_surf_samples: int = 8, min_depth: float = 0.07,
                 sdf_gate: float = 0.3, eager: bool = False):
        self.model = model
        self.n_rays = n_rays
        self.n_surf_samples = n_surf_samples
        self.min_depth = min_depth
        self.sdf_gate = sdf_gate
        self.eager = eager
        self.graphs = None      # utils/graphs.GraphRunner, at first use
        self._captured = {}     # key -> (Captured, inputs, outputs)
        self._captured_on = None

    def draw(self, gen, F: int, H: int, W: int, device):
        """The burst's sample set: pixels (ib, ih, iw) [F * n_rays] and
        Gaussian depth offsets [F * n_rays, n_surf_samples - 1] (5 cm)."""
        ib, ih, iw = S.sample_pixels(gen, self.n_rays, F, H, W, device)
        offs = 0.05 * torch.randn((ib.shape[0], self.n_surf_samples - 1),
                                  generator=gen, device=device)
        return ib, ih, iw, offs

    def solve(self, params, twists, depth_frames, T_WC, rows, dirs_C_img,
              transform, draws, n_steps: int = 1):
        """``n_steps`` LM iterations from ``twists`` [C, 6] for the frames
        depth_frames [F, H, W] / T_WC [F, 4, 4] at arena rows ``rows``.
        Returns (twists [C, 6], losses [n_steps + 1]): the truncated mean
        |sdf| per iteration, losses[0] the loss before the burst."""
        ib, ih, iw, offs = draws
        F = depth_frames.shape[0]
        dev = depth_frames.device
        gate = self.sdf_gate
        depth = depth_frames[ib, ih, iw]
        valid = depth != 0.0
        depth_safe = torch.where(valid, depth, 1.0)
        dirs_C = dirs_C_img[ih, iw]
        # camera-frame surface samples, fixed across iterations: the depth
        # itself and n_surf - 1 offsets along the ray
        z = torch.cat([depth_safe[:, None],
                       (depth_safe[:, None] + offs).clamp(
                           min=self.min_depth)], dim=1)
        x_C = dirs_C[:, None, :] * z[:, :, None]              # [R, S, 3]
        w_base = valid[:, None].expand(x_C.shape[:2]).float()
        n_valid = w_base.sum().clamp(min=1.0)

        def residuals(tw):
            T_f = corrected_poses(tw[rows], T_WC)             # [F, 4, 4]
            T_c = T_f[ib]
            x = (torch.einsum("rij,rsj->rsi", T_c[:, :3, :3], x_C)
                 + T_c[:, None, :3, 3])
            sdf, g = M.sdf_and_grad(params, x.reshape(-1, 3), self.model,
                                    transform=transform)
            r = sdf.reshape(x.shape[:2])
            g = g.reshape(x.shape)
            gn = g.norm(dim=-1)
            grad_ok = (gn > 0.5) & (gn < 1.5)
            w = w_base * (r.abs() < gate) * grad_ok
            # truncated over every valid sample: averaging the inliers only
            # would reward pushing samples out of the gate
            rho = torch.where(grad_ok, r.abs().clamp(max=gate),
                              torch.full_like(r, gate))
            loss = (rho * w_base).sum() / n_valid
            return loss, (r, g, x, w, T_f[:, :3, 3])

        by_frame = segment_onehot(ib, F)                      # [F, R]
        by_row = segment_onehot(rows, twists.shape[0])        # [C, F]

        def seg(v):
            return segment_sum(v, by_frame)

        loss, aux = residuals(twists)
        lam_scale = torch.full((), 1e-2, device=dev)
        losses = [loss]
        for _ in range(n_steps):
            r, g, x, w, cam_f = aux
            cam = cam_f[ib]
            J = torch.cat([torch.linalg.cross(x - cam[:, None, :], g), g],
                          dim=-1)                              # [R, S, 6]
            Jw = J * w[..., None]
            H6 = seg(torch.einsum("rsi,rsj->rij", Jw, J))
            b6 = seg(-torch.einsum("rsi,rs->ri", Jw, r))
            # damping relative to the largest eigenvalue: a planar wall
            # cannot observe in-plane sliding, and lam ~ e_max suppresses
            # those near-null directions. isdf_tpu solves by eigh, V
            # diag(1 / (e + lam)) V^T b6, which is (H6 + lam I)^-1 b6
            lam = (lam_scale.clamp(min=3e-2) * top_eigenvalue(H6)[:, None]
                   + 1e-8)                                     # [F, 1]
            eye = torch.eye(6, device=dev)
            delta = spd_solve(H6 + lam[:, :, None] * eye, b6)  # [F, 6]
            # trust region and the no-inlier guard
            n_in = seg(w.sum(dim=1))
            scale = (0.05 / delta.abs().amax(dim=1, keepdim=True).clamp(
                min=1e-12)).clamp(max=1.0)
            delta = torch.where(n_in[:, None] >= 6.0, delta * scale, 0.0)
            # camera-centred (omega, v_c) -> world twist about the centres
            dv = delta[:, 3:] - torch.linalg.cross(delta[:, :3], cam_f)
            cand = twists + segment_sum(torch.cat([delta[:, :3], dv], dim=1),
                                        by_row)
            new_loss, new_aux = residuals(cand)
            # one accept for the whole burst (the loop refines one frame)
            accept = new_loss < loss - 1e-4
            twists = torch.where(accept, cand, twists)
            aux = tuple(torch.where(accept, b, a)
                        for a, b in zip(aux, new_aux))
            lam_scale = torch.where(accept, (lam_scale / 3.0).clamp(min=1e-4),
                                    (lam_scale * 10.0).clamp(max=1e3))
            loss = torch.where(accept, new_loss, loss)
            losses.append(loss)
        return twists, torch.stack(losses)

    def __call__(self, params, state: PoseState, depth_frames, T_WC, rows,
                 dirs_C_img, transform, gen, n_steps: int = 1):
        """One burst: draw a sample set from ``gen`` and solve on it.
        Returns (PoseState, losses [n_steps + 1]). On the card, a replay of
        the burst captured for this shape, generator and map."""

        def burst(twists, depth_frames, T_WC, rows):
            F, H, W = depth_frames.shape
            draws = self.draw(gen, F, H, W, depth_frames.device)
            return self.solve(params, twists, depth_frames, T_WC, rows,
                              dirs_C_img, transform, draws, n_steps=n_steps)

        args = (state.twists, depth_frames, T_WC, rows)
        if self.eager or (self.graphs is None
                          and depth_frames.device.type != "cuda"):
            twists, losses = burst(*args)
            return PoseState(twists), losses
        from isdf_tpu_torch.utils import graphs as G
        if self.graphs is None:
            self.graphs = G.GraphRunner(depth_frames.device)
        # the graphs read the map, the rays, the transform and the
        # generator they were captured with; the per-burst tensors are
        # copied into their inputs
        on = G.captured_on([gen, dirs_C_img, transform]
                           + [params[k] for k in sorted(params)], transform)
        if not G.same_inputs(on, self._captured_on):
            self._captured.clear()
            self._captured_on = on
        key = (tuple(a.shape for a in args), n_steps)
        hit = self._captured.get(key)
        if hit is None:
            twists, losses = self.graphs.warm(lambda: burst(*args))
            ins = [a.clone() for a in args]
            outs = [torch.empty_like(twists), torch.empty_like(losses)]

            def captured():
                for o, v in zip(outs, burst(*ins)):
                    o.copy_(v)
            self._captured[key] = (self.graphs.capture(
                captured, generators=(gen,)), ins, outs)
            return PoseState(twists), losses
        graph, ins, outs = hit
        for i, a in zip(ins, args):
            i.copy_(a)
        graph.replay()
        return PoseState(outs[0].clone()), outs[1].clone()
