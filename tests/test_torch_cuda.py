"""The port's CUDA kernels on the card, and their wrappers' contract.

This file imports neither jax nor isdf_tpu, so it also runs on a machine
with a GPU and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tests marked ``cuda`` skip without a CUDA device: the kernels have no CPU
mode. Kernel vs plain version tolerances (both with bf16 hidden products)
are about 10x the largest gap read on an H100 at this test's size, N =
5,400 points (PERF.md, section 6): loss sums 1.5e-4 relative
(read: 1.5e-5), per-point loss 5e-3 of its largest magnitude (read:
8.4e-4), each gradient block (a layer's weight rows, the skip layer's pe
rows apart, and a layer's bias) 1.5e-3 of its own largest magnitude (read:
1.4e-4 for K1, 1.0e-4 for K3), K2's raw sdf and each column of d raw/dx
7e-2 of their largest magnitude (read: 6.4e-3; single points sit on bf16
rounding boundaries, see PERF.md), K4's indices exactly. chip_smoke.py
holds the full-size calls (N = 27,000). K1's 384-lane build (E = 381) is
held at N = 27,000 to the same limits: the same bf16 products, only deeper
in layer 0 and the skip layer, and its gaps read within them (sums
2.5e-6, per-point loss 1.2e-3, blocks 9.3e-5: chip_smoke.py's K1-ray-384
row, PERF.md section 6). The query kernel
(csrc/query_mlp.cu) in both modes against the eager chain in float32 (TF32
off), through the serve engine: max |kernel - eager| over the largest
|eager| of the request, TOL_QUERY, about 10x the largest gap an H100 read
over these cases (values 6.3e-7, gradients 1.9e-6, at n = 37 and 1).
"""

import numpy as np
import pytest
import torch

from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models import cuda_query as CQ
from isdf_tpu_torch.models import cuda_reverse_fused as CRF
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp
from isdf_tpu_torch.ops import cuda_bounds as CB

KW = dict(loss_type="L1", trunc_distance=0.29365022, trunc_weight=5.3834402,
          eik_apply_dist=0.1, eik_weight=0.268, grad_weight=0.018,
          orien_loss=False)
TOL_SUMS_REL, TOL_PLOSS, TOL_GRAD = 1.5e-4, 5e-3, 1.5e-3
TOL_RAW = 7e-2
TOL_QUERY = 2e-5


def _inputs(device, R=200, S=27, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = rng.uniform(0.8, 3.0, R)
    z = np.sort(rng.uniform(0.07, 1.0, (R, S)) * (depth[:, None] + 0.1), 1)
    z[:, 0] = depth
    pc = o[:, None] + d[:, None] * z[..., None]
    valid = rng.random(R) > 0.1
    nrm = rng.normal(size=(R, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    N = R * S
    f = dict(pts=pc.reshape(N, 3), surf=pc[:, 0], surf_valid=valid,
             zd=(z - depth[:, None]).reshape(N),
             normals_pt=np.repeat(nrm, S, 0),
             is_surf=np.tile(np.eye(1, S)[0], R),
             valid=np.repeat(valid, S), noise=rng.normal(size=N) * 0.04,
             bounds=(depth[:, None] - z).reshape(N),
             gt=np.repeat(-d, S, 0))
    out = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
           .contiguous() for k, v in f.items()}
    out["inv_count"] = torch.tensor(1.0 / float(out["valid"].sum()),
                                    device=device)
    return out


def _args(params, T, x, pc):
    if pc:
        return (params, T, x["pts"], x["surf"], x["surf_valid"], x["zd"],
                x["normals_pt"], x["is_surf"], x["valid"], x["noise"],
                x["inv_count"])
    return (params, T, x["pts"], x["bounds"], x["valid"], x["noise"],
            x["gt"], x["inv_count"])


def _setup(device, R=200):
    model = TM.SDFModel()
    params = TM.init_params(torch.Generator().manual_seed(0), model,
                            device=device)
    T = torch.eye(4, device=device)
    T[:3, 3] = torch.tensor([0.1, -0.2, 0.3], device=device)
    return model, params, T, _inputs(device, R=R)


def _blocks(model, dW, db):
    H = model.hidden_size
    out = []
    for l, (w, b) in enumerate(TM.unpack({"Wp": dW, "bp": db}, model)):
        out += [w[:H], w[H:], b] if l == model.cat_idx else [w, b]
    return out


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("pc,loss_type,orien", [
    (True, "L1", False), (False, "L1", False), (True, "L2", False),
    (False, "L2", True)])
def test_kernel_matches_plain_on_card(pc, loss_type, orien):
    _need_card()
    model, params, T, x = _setup("cuda")
    kn = dict(KW, loss_type=loss_type, orien_loss=orien)
    op = K.make_train_op(model, **kn, pc_bounds=pc)
    name = "K1-pc" if pc else "K1-ray"
    n0 = K.LAUNCHES[name]
    ks, kp, (kdw, kdb) = op(*_args(params, T, x, pc))
    assert K.LAUNCHES[name] == n0 + 1
    M, dxs, dproj2 = TM._pe_consts(model, T, device="cuda")
    lk = K._loss_knobs(model, free_space_factor=5.0, **kn)
    kw = (dict(surf=x["surf"], surf_valid=x["surf_valid"], zd=x["zd"],
               normals_pt=x["normals_pt"], is_surf=x["is_surf"])
          if pc else dict(bounds=x["bounds"], gt=x["gt"]))
    ps, pp, (pdw, pdb) = K.train_op_plain(
        params, model, lk, M, K.tangent_rows(model, dxs, dproj2), x["pts"],
        x["valid"], x["noise"], x["inv_count"], **kw)
    torch.cuda.synchronize()
    sums_rel = ((ks - ps).abs() / ps.abs()).max().item()
    assert sums_rel <= TOL_SUMS_REL, sums_rel
    for a in (kp, kdw, kdb):
        assert torch.isfinite(a).all()
    ploss_err = ((kp - pp).abs().max() / pp.abs().max()).item()
    assert ploss_err <= TOL_PLOSS, ploss_err
    errs = [((a - r).abs().max() / r.abs().max()).item() for a, r in zip(
        _blocks(model, kdw, kdb), _blocks(model, pdw, pdb))]
    assert max(errs) <= TOL_GRAD, f"gradient blocks: {errs}"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pc", "ray", "stream"])
def test_wide_kernel_matches_plain_on_card(variant):
    """K1's 384-lane build (n_embed_funcs 8, E = 381, the live configs)
    against the plain op at N = 27,000, the trainer's size, one launch
    counted under its own key; two calls give the same bits."""
    _need_card()
    model = TM.SDFModel(embedding_size=381, max_deg=8)
    params = TM.init_params(torch.Generator().manual_seed(0), model,
                            device="cuda")
    T = torch.eye(4, device="cuda")
    T[:3, 3] = torch.tensor([0.1, -0.2, 0.3], device="cuda")
    x = _inputs("cuda", R=1000)
    assert x["pts"].shape[0] == 27000
    pc, stream = variant == "pc", variant == "stream"
    op = K.make_train_op(model, **KW, pc_bounds=pc, pe_in_kernel=not stream)
    key = f"K1-{variant}-384"
    n0 = K.LAUNCHES[key]
    lk = K._loss_knobs(model, free_space_factor=5.0, **KW)
    if stream:
        pe, _, dxs, dproj2 = TM._pe_factored(x["pts"], model, T)
        args = (params, pe, dxs, dproj2, x["bounds"], x["valid"], x["noise"],
                x["gt"], x["inv_count"])
        Tc, M, kw = K.tangent_rows(model, dxs, dproj2), None, dict(
            bounds=x["bounds"], gt=x["gt"], pe=pe)
    else:
        args = _args(params, T, x, pc)
        M, dxs, dproj2 = TM._pe_consts(model, T, device="cuda")
        Tc = K.tangent_rows(model, dxs, dproj2)
        kw = (dict(surf=x["surf"], surf_valid=x["surf_valid"], zd=x["zd"],
                   normals_pt=x["normals_pt"], is_surf=x["is_surf"])
              if pc else dict(bounds=x["bounds"], gt=x["gt"]))
    ks, kp, (kdw, kdb) = op(*args)
    again = op(*args)
    assert K.LAUNCHES[key] == n0 + 2
    assert kdw.shape == (model.n_layers, 768, 256)
    ps, pp, (pdw, pdb) = K.train_op_plain(
        params, model, lk, M, Tc, x["pts"], x["valid"], x["noise"],
        x["inv_count"], **kw)
    torch.cuda.synchronize()
    assert ((ks - ps).abs() / ps.abs()).max().item() <= TOL_SUMS_REL
    assert _rel(kp, pp) <= TOL_PLOSS
    errs = [_rel(a, r) for a, r in zip(_blocks(model, kdw, kdb),
                                       _blocks(model, pdw, pdb))]
    assert max(errs) <= TOL_GRAD, f"gradient blocks: {errs}"
    for u, v in zip((ks, kp, kdw, kdb), (again[0], again[1], *again[2])):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_wide_bundle_span_names_the_384_lane_op_on_card():
    """A traced bundle of a live-config map records its train op's variant
    and lanes and the call's shape (utils/profiling.py spans)."""
    _need_card()
    from isdf_tpu_torch.utils import profiling as P
    tr = _graph_trainer(False, n_embed_funcs=8)
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    tr.run_steps(2)
    P.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.run_steps(3)
    spans = [s for s in P.recorded() if s.name == "step.bundle"]
    assert spans and all(s.counts["train_op"] == "K1-pc/384"
                         and s.counts["embedding"] == 381
                         and s.counts["points"] == 5 * 200 * 27
                         and s.counts["layers"] == 7
                         and s.counts["blocks_per_sm"] == 2 for s in spans)


@pytest.mark.cuda
def test_k1_builds_hold_their_blocks_an_sm_on_card():
    """isdf_train_mlp_occupancy: two resident blocks an SM of k_train_tile
    in every mode at 256 lanes and in the 384-lane build (E = 381), one in
    the f32-product mode."""
    _need_card()
    builds = [(TM.SDFModel(), 2),
              (TM.SDFModel(embedding_size=381, max_deg=8), 2),
              (TM.SDFModel(mm_precision="highest"), 1)]
    for model, want in builds:
        got = [K.blocks_per_sm(m, model, "cuda") for m in K.MODES]
        assert got == [want] * 3, (K.source("train_mlp", model), got)


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card():
    """No atomics: two calls on the same inputs give the same bits."""
    _need_card()
    model, params, T, x = _setup("cuda")
    op = K.make_train_op(model, **KW, pc_bounds=True)
    a = op(*_args(params, T, x, True))
    b = op(*_args(params, T, x, True))
    for u, v in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("pc", [True, False])
def test_kernel_matches_plain_at_a_ragged_size_on_card(pc):
    """N = 5,373 (199 rays x 27): the last tile holds 61 rows and the last
    of the split-K row ranges 96 rows against 352 for the others."""
    _need_card()
    model, params, T, x = _setup("cuda", R=199)
    N = x["pts"].shape[0]
    geo = K.k1_geometry(N, model.n_layers)
    assert N % K.TM and geo["NP"] - (geo["S"] - 1) * geo["rps"] < geo["rps"]
    op = K.make_train_op(model, **KW, pc_bounds=pc)
    ks, kp, (kdw, kdb) = op(*_args(params, T, x, pc))
    M, dxs, dproj2 = TM._pe_consts(model, T, device="cuda")
    lk = K._loss_knobs(model, free_space_factor=5.0, **KW)
    kw = (dict(surf=x["surf"], surf_valid=x["surf_valid"], zd=x["zd"],
               normals_pt=x["normals_pt"], is_surf=x["is_surf"])
          if pc else dict(bounds=x["bounds"], gt=x["gt"]))
    ps, pp, (pdw, pdb) = K.train_op_plain(
        params, model, lk, M, K.tangent_rows(model, dxs, dproj2), x["pts"],
        x["valid"], x["noise"], x["inv_count"], **kw)
    torch.cuda.synchronize()
    assert ((ks - ps).abs() / ps.abs()).max().item() <= TOL_SUMS_REL
    assert kp.shape == (N,) and _rel(kp, pp) <= TOL_PLOSS
    errs = [_rel(a, r) for a, r in zip(_blocks(model, kdw, kdb),
                                       _blocks(model, pdw, pdb))]
    assert max(errs) <= TOL_GRAD, f"gradient blocks: {errs}"


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [256, 384])
def test_kernel_is_deterministic_at_full_size_on_card(lanes):
    """N = 27,000, the trainer's size: two calls give the same bits, at 256
    lanes and in the 384-lane build (E = 381)."""
    _need_card()
    model, params, T, x = _setup("cuda", R=1000)
    if lanes == 384:
        model = TM.SDFModel(embedding_size=381, max_deg=8)
        params = TM.init_params(torch.Generator().manual_seed(0), model,
                                device="cuda")
    assert K.pe_lanes(model) == lanes
    op = K.make_train_op(model, **KW, pc_bounds=True)
    a = op(*_args(params, T, x, True))
    b = op(*_args(params, T, x, True))
    for u, v in zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_trainer_launches_the_kernel_once_per_step_on_card():
    _need_card()
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config
    cam = Config().camera.__class__(160, 120, 100.0, 100.0, 79.5, 59.5)
    cfg = Config().replace(dataset_format="synthetic", bounds_method="pc",
                           kf_buffer_size=16, camera=cam)
    tr = Trainer(cfg)
    assert tr.device.type == "cuda" and tr.fns.uses_kernel
    tr._per_step_device_s = 1.0 / 300
    n0 = K.LAUNCHES["K1-pc"]
    res = train_loop(tr, max_steps=40)
    assert K.LAUNCHES["K1-pc"] - n0 == res.steps == 40


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
def test_stream_kernel_matches_plain_on_card():
    _need_card()
    model, params, T, x = _setup("cuda")
    pe, _, dxs, dproj2 = TM._pe_factored(x["pts"], model, T)
    op = K.make_train_op(model, **KW, pe_in_kernel=False)
    n0 = K.LAUNCHES["K1-stream"]
    ks, kp, (kdw, kdb) = op(params, pe, dxs, dproj2, x["bounds"], x["valid"],
                            x["noise"], x["gt"], x["inv_count"])
    assert K.LAUNCHES["K1-stream"] == n0 + 1
    lk = K._loss_knobs(model, free_space_factor=5.0, **KW)
    ps, pp, (pdw, pdb) = K.train_op_plain(
        params, model, lk, None, K.tangent_rows(model, dxs, dproj2), None,
        x["valid"], x["noise"], x["inv_count"], bounds=x["bounds"],
        gt=x["gt"], pe=pe)
    torch.cuda.synchronize()
    sums_rel = ((ks - ps).abs() / ps.abs()).max().item()
    errs = [_rel(a, r) for a, r in zip(_blocks(model, kdw, kdb),
                                       _blocks(model, pdw, pdb))]
    print(f"K1-stream: sums {sums_rel:.3e} ploss {_rel(kp, pp):.3e} "
          f"blocks {max(errs):.3e}")
    assert sums_rel <= TOL_SUMS_REL
    assert _rel(kp, pp) <= TOL_PLOSS
    assert max(errs) <= TOL_GRAD, f"gradient blocks: {errs}"


def _k4_case(kind):
    """The inputs chip_smoke.py's K4 check holds, at this file's size:
    the trainer's (surface set the strided view pc[:, 0]), exact ties
    (every surface point twice, in other groups of the kernel, most also
    in one group's consecutive runs, and +-pairs on the axes), ragged
    (M = 5,373, R = 997), one valid surface point, none valid."""
    x = _inputs("cuda", R=1000)
    pc = x["pts"].view(1000, 27, 3)
    surf, sv = pc[:200, 0], x["surf_valid"][:200] > 0.5
    pts = x["pts"][:5400]
    if kind == "trainer":
        return pts, surf, sv
    if kind == "ties":
        rng = np.random.default_rng(3)
        axes = np.array([[2, 0, 0], [-2, 0, 0], [0, 2, 0], [0, -2, 0],
                         [0, 0, 2], [0, 0, -2]], np.float32)
        u = rng.normal(size=(6, 8, 3))  # rows r and r + 8 equal too
        half = np.concatenate([np.concatenate([u, u], 1).reshape(-1, 3)[:94],
                               axes])
        on_axes = np.zeros((1000, 3))
        on_axes[np.arange(1000), rng.integers(0, 3, 1000)] = \
            rng.integers(-4, 5, 1000) * 0.25
        p = np.concatenate([on_axes, rng.normal(size=(4000, 3))])
        valid = np.ones(200, bool)
        valid[[94, 195]] = False
        return (torch.as_tensor(p, dtype=torch.float32, device="cuda"),
                torch.as_tensor(np.concatenate([half, half]),
                                dtype=torch.float32, device="cuda"),
                torch.as_tensor(valid, device="cuda"))
    if kind == "ragged":
        return (x["pts"][:5373], pc[3:, 0],
                x["surf_valid"][3:] > 0.5)
    one = torch.zeros_like(sv)
    if kind == "one_valid":
        one[137] = True
    return pts, surf, one


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["trainer", "ties", "ragged", "one_valid",
                                  "none_valid"])
def test_closest_surface_kernel_matches_plain_on_card(kind):
    """One launch a call, the plain version's indices exactly, the same
    bits in two calls."""
    _need_card()
    pts, surf, sv = _k4_case(kind)
    n0 = CB.LAUNCHES["K4"]
    got = CB.closest_surface_ix(pts, surf, sv)
    assert CB.LAUNCHES["K4"] == n0 + 1
    want = CB.closest_surface_ix_plain(pts, surf, sv)
    assert torch.equal(got, want)
    assert torch.equal(CB.closest_surface_ix(pts, surf, sv), got)
    if kind == "none_valid":
        assert not got.any()  # no valid surface point: index 0, as argmin
    if kind == "one_valid":
        assert (got == 137).all()


def _rf_loss(raw, graw):
    eik = (graw.norm(dim=-1) - 1.0).abs().mean()
    gsum = (graw * torch.tensor([0.2, -0.5, 1.0], device=graw.device)
            ).sum(-1).mean()
    return raw.abs().mean() + 0.3 * eik + 0.1 * gsum


@pytest.mark.cuda
def test_reverse_fused_kernels_match_plain_on_card():
    """K2's raw and d raw/dx, and K3's gradient blocks on the same
    cotangents, against make_reverse_fused_mlp's plain op."""
    _need_card()
    model, params, T, x = _setup("cuda")
    args = TM._pe_factored(x["pts"], model, T)
    out = {}
    for kind, op in (("kernel", CRF.make_cuda_reverse_fused(model)),
                     ("plain", make_reverse_fused_mlp(model))):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        raw, graw = op(p, *args)
        out[kind] = (p, raw, graw)
    (pk, rk, gk), (pp, rp, gp) = out["kernel"], out["plain"]
    fwd = [_rel(rk, rp)] + [_rel(gk[:, c], gp[:, c]) for c in range(3)]
    print(f"K2: raw, graw {fwd}")
    assert max(fwd) <= TOL_RAW
    draw, dgraw = torch.autograd.grad(_rf_loss(rk, gk), (rk, gk),
                                      retain_graph=True)
    n0 = dict(CRF.LAUNCHES)
    kg = torch.autograd.grad((rk, gk), (pk["Wp"], pk["bp"]), (draw, dgraw))
    assert CRF.LAUNCHES["K3"] == n0["K3"] + 1
    pg = torch.autograd.grad((rp, gp), (pp["Wp"], pp["bp"]), (draw, dgraw))
    errs = [_rel(a, r) for a, r in zip(_blocks(model, *kg),
                                       _blocks(model, *pg))]
    print(f"K3: blocks {max(errs):.3e}")
    assert max(errs) <= TOL_GRAD, f"gradient blocks: {errs}"


@pytest.mark.cuda
def test_reverse_fused_backward_kernel_is_deterministic_on_card():
    """K3 has no atomics: two calls on the same inputs give the same
    bits."""
    _need_card()
    model, params, T, x = _setup("cuda")
    pe, _, dxs, dproj2 = TM._pe_factored(x["pts"], model, T)
    Tc = K.tangent_rows(model, dxs, dproj2).contiguous()
    g = torch.Generator(device="cuda").manual_seed(0)
    draw = torch.randn(pe.shape[0], device="cuda", generator=g) * 1e-4
    dgraw = torch.randn(pe.shape[0], 3, device="cuda", generator=g) * 1e-4
    a = CRF.rf_backward_cuda(params, model, pe, Tc, draw, dgraw)
    b = CRF.rf_backward_cuda(params, model, pe, Tc, draw, dgraw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs,kernels", [
    (dict(pe_in_kernel=False, use_pallas=True), ("K1-stream", "K4")),
    (dict(grad_mode="reverse_fused", use_pallas=True), ("K4",)),
])
def test_trainer_new_paths_launch_once_per_step_on_card(knobs, kernels):
    _need_card()
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config
    cam = Config().camera.__class__(160, 120, 100.0, 100.0, 79.5, 59.5)
    cfg = Config().replace(dataset_format="synthetic", bounds_method="pc",
                           kf_buffer_size=16, camera=cam, **knobs)
    tr = Trainer(cfg)
    tr._per_step_device_s = 1.0 / 300
    counts = (K.LAUNCHES, CB.LAUNCHES, CRF.LAUNCHES)
    n0 = {k: v for d in counts for k, v in d.items()}
    res = train_loop(tr, max_steps=40)
    n1 = {k: v for d in counts for k, v in d.items()}
    assert res.steps == 40
    assert {k: n1[k] - n0[k] for k in n1} == {
        k: 40 if k in kernels else 0 for k in n1}


def test_wrapper_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only; CPU tensors go to the plain
    version through make_train_op, never into the kernel."""
    model, params, T, x = _setup("cpu")
    M, dxs, dproj2 = TM._pe_consts(model, T)
    lk = K._loss_knobs(model, free_space_factor=5.0, **KW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.train_op_cuda(params, model, lk, M,
                        K.tangent_rows(model, dxs, dproj2), x["pts"],
                        x["valid"], x["noise"], x["inv_count"],
                        bounds=x["bounds"], gt=x["gt"])


def test_new_wrappers_refuse_cpu_tensors():
    """K4's, K2/K3's and the query kernel's paths take CUDA tensors
    only."""
    model, params, T, x = _setup("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        CB.closest_surface_ix_cuda(x["pts"], x["surf"], x["surf_valid"])
    pe, _, dxs, dproj2 = TM._pe_factored(x["pts"], model, T)
    Tc = K.tangent_rows(model, dxs, dproj2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CRF.rf_forward_cuda(params, model, pe, Tc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.train_op_cuda(params, model, K._loss_knobs(
            model, free_space_factor=5.0, **KW), None, Tc, None, x["valid"],
            x["noise"], x["inv_count"], bounds=x["bounds"], gt=x["gt"],
            pe=pe)
    for grad in (False, True):
        out = torch.empty((x["pts"].shape[0], 3) if grad
                          else x["pts"].shape[0])
        with pytest.raises(ValueError, match="CUDA tensor"):
            CQ.query_cuda(params, x["pts"], model, T, out, grad)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CQ.query_preact(params, x["pts"], model, T)


def _query_case(n, chunk):
    """The serve engine on the card over a seeded map with a scene frame
    turned about two axes and shifted, and n points in a 6 x 4 x 3 m room."""
    import math

    from isdf_tpu_torch.serve import SDFQueryEngine
    model = TM.SDFModel()
    params = TM.init_params(torch.Generator().manual_seed(0), model,
                            device="cuda")
    a, b = 0.4, -0.3
    Rz = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                       [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    Rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, math.cos(b), -math.sin(b)],
                       [0.0, math.sin(b), math.cos(b)]])
    T = torch.eye(4)
    T[:3, :3] = Rx @ Rz
    T[:3, 3] = torch.tensor([-0.4, 0.25, 0.6])
    pts = ((np.random.default_rng(n).random((n, 3)) - 0.5)
           * [6.0, 4.0, 3.0]).astype(np.float32)
    eng = SDFQueryEngine(params=params, model=model, transform=T.cuda(),
                         chunk_size=chunk)
    return eng, pts


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("chunk", [64, 65536])
@pytest.mark.parametrize("n", [1, 37, 4097, 65536 + 129])
def test_query_kernel_matches_eager_on_card(n, chunk, grad):
    """The engine's kernel route, one launch a chunk, against the eager
    apply / sdf_and_grad on the same map, in chunks of at most 65,536."""
    _need_card()
    eng, pts = _query_case(n, chunk)
    assert eng.route == "kernel"
    key = "query_grad" if grad else "query_sdf"
    n0 = CQ.LAUNCHES[key]
    got = torch.as_tensor(eng.grad(pts) if grad else eng.sdf(pts))
    assert CQ.LAUNCHES[key] - n0 == -(-n // chunk)
    x = torch.as_tensor(pts, device="cuda")
    want = []
    for i in range(0, n, 65536):
        if grad:
            want.append(TM.sdf_and_grad(eng.params, x[i:i + 65536],
                                        eng.model,
                                        transform=eng.transform)[1])
        else:
            with torch.no_grad():
                want.append(TM.apply(eng.params, x[i:i + 65536], eng.model,
                                     transform=eng.transform))
    want = torch.cat(want).cpu()
    gap = _rel(got, want)
    print(f"query {key} n {n} chunk {chunk}: gap {gap:.3e}")
    assert gap <= TOL_QUERY, f"{key} n {n} chunk {chunk}: gap {gap:.3e}"


@pytest.mark.cuda
def test_query_kernel_preactivations_are_the_eager_chains_bits():
    """Each hidden layer's pre-activation in the query kernel (a W + b,
    before the softplus) equals the eager chain's bit for bit at the serve
    engine's chunk of 65,536 points, and its values are the serving
    kernel's. The gradient rests on it: at a pre-activation of exactly 0
    the derivative is 1, where the sigmoid gives 1/2, so a sum that cancels
    in one chain and not in the other moves that point's gradient by a few
    percent. It holds while the card's f32 GEMMs sum as the kernel does; a
    library that sums otherwise fails here."""
    _need_card()
    eng, pts = _query_case(65536, 65536)
    model, params, T = eng.model, eng.params, eng.transform
    x = torch.as_tensor(pts, device="cuda")
    vals, z = CQ.query_preact(params, x, model, T)
    served = torch.empty_like(vals)
    CQ.query_cuda(params, x, model, T, served, False)
    with torch.no_grad():
        pe = model.encode(params, x, transform=T)
        h, want = pe, []
        for l, (w, b) in enumerate(TM.unpack(params, model)[:-1]):
            if l == model.cat_idx:
                h = torch.cat([h, pe], dim=-1)
            want.append(h @ w + b)
            h = TM.softplus_b100(want[-1])
    torch.cuda.synchronize()
    rows = [(int((z[l] != zw).sum()), int((zw == 0).sum()),
             int((z[l] == 0).sum())) for l, zw in enumerate(want)]
    print("pre-activations by layer (differing, eager zeros, kernel zeros):",
          rows)
    assert torch.equal(vals, served)
    assert all(d == 0 for d, _, _ in rows), rows


@pytest.mark.cuda
def test_engine_reads_what_the_callers_stream_wrote_before_it():
    """The engine runs a request on a stream of its own, after the work
    the caller's stream has queued: a head bias written there behind some
    30 ms of other work is the one the next request reads."""
    _need_card()
    eng, pts = _query_case(4097, 65536)
    before = eng.sdf(pts)
    torch.cuda._sleep(50_000_000)
    eng.params["bp"][-1, 0] += 1.0
    after = eng.sdf(pts)
    np.testing.assert_allclose(after, before + eng.model.scale_output,
                               rtol=0, atol=1e-5 * eng.model.scale_output)


def test_plain_version_on_cpu_never_counts_a_launch():
    model, params, T, x = _setup("cpu")
    before = dict(K.LAUNCHES)
    sums, ploss, (dW, db) = K.make_train_op(model, **KW, pc_bounds=True)(
        *_args(params, T, x, True))
    assert K.LAUNCHES == before
    assert ploss.shape == (x["pts"].shape[0],)
    assert dW.shape == params["Wp"].shape
    assert torch.isfinite(sums).all() and sums[4] == x["valid"].sum()


def test_profile_step_reads_idle_share_from_trace_intervals(tmp_path):
    """busy_us is the union of kernel intervals: overlaps count once."""
    import json
    from isdf_tpu_torch.train import profile_step as P
    ev = [dict(cat="kernel", ph="X", ts=0, dur=10, name="a"),
          dict(cat="kernel", ph="X", ts=5, dur=10, name="b"),
          dict(cat="kernel", ph="X", ts=30, dur=5, name="a"),
          dict(cat="cuda_runtime", ph="X", ts=15, dur=15, name="launch")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    ivs = P.kernel_intervals(str(path))
    assert [n for _, _, n in ivs] == ["a", "b", "a"]
    assert P.busy_us(ivs) == 20.0


# the f32-product mode (tpu.mm_precision other than "default") against the
# plain version with f32 products, at this file's size: the kernels sum six
# split-bf16 tensor-core products a product, the plain version IEEE f32
# ones. About 10x the largest gap the mode's first design (IEEE f32 FMAs)
# read on an H100: sums 1.2e-7, per-point loss 2.2e-7, gradient blocks
# 6.2e-7 (K1) and 5.3e-7 (K3), K2 2.1e-6; the split design reads 1.5e-7,
# 2.2e-7, 8.0e-7 and 7.7e-7, K2 2.4e-6 (PERF.md, section 6)
TOL_F32_SUMS, TOL_F32_PLOSS, TOL_F32_GRAD, TOL_F32_RAW = 1.5e-6, 3e-6, \
    1e-5, 3e-5


def _f32_setup():
    model, params, T, x = _setup("cuda")
    return TM.SDFModel(mm_precision="highest"), params, T, x


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pc", "ray", "stream"])
def test_f32_train_kernel_matches_plain_on_card(variant):
    _need_card()
    model, params, T, x = _f32_setup()
    lk = K._loss_knobs(model, free_space_factor=5.0, **KW)
    M, dxs, dproj2 = TM._pe_consts(model, T, device="cuda")
    Tc = K.tangent_rows(model, dxs, dproj2)
    name = f"K1-{variant}-f32"
    n0 = dict(K.LAUNCHES)
    if variant == "stream":
        pe, _, dxs, dproj2 = TM._pe_factored(x["pts"], model, T)
        op = K.make_train_op(model, **KW, pe_in_kernel=False)
        out = op(params, pe, dxs, dproj2, x["bounds"], x["valid"],
                 x["noise"], x["gt"], x["inv_count"])
        kw = dict(bounds=x["bounds"], gt=x["gt"], pe=pe)
        Tc = K.tangent_rows(model, dxs, dproj2)
    else:
        op = K.make_train_op(model, **KW, pc_bounds=variant == "pc")
        out = op(*_args(params, T, x, variant == "pc"))
        kw = (dict(surf=x["surf"], surf_valid=x["surf_valid"], zd=x["zd"],
                   normals_pt=x["normals_pt"], is_surf=x["is_surf"])
              if variant == "pc" else dict(bounds=x["bounds"], gt=x["gt"]))
    assert {k: K.LAUNCHES[k] - n0[k] for k in n0} == {
        k: int(k == name) for k in n0}
    ks, kp, (kdw, kdb) = out
    ps, pp, (pdw, pdb) = K.train_op_plain(
        params, model, lk, M, Tc, x["pts"], x["valid"], x["noise"],
        x["inv_count"], mm_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    sums_rel = ((ks - ps).abs() / ps.abs()).max().item()
    errs = [_rel(a, r) for a, r in zip(_blocks(model, kdw, kdb),
                                       _blocks(model, pdw, pdb))]
    print(f"{name}: sums {sums_rel:.3e} ploss {_rel(kp, pp):.3e} "
          f"blocks {max(errs):.3e}")
    assert sums_rel <= TOL_F32_SUMS
    assert _rel(kp, pp) <= TOL_F32_PLOSS
    assert max(errs) <= TOL_F32_GRAD, f"gradient blocks: {errs}"
    again = op(*_args(params, T, x, variant == "pc")) if variant != \
        "stream" else op(params, pe, dxs, dproj2, x["bounds"], x["valid"],
                         x["noise"], x["gt"], x["inv_count"])
    assert torch.equal(again[2][0], kdw) and torch.equal(again[1], kp)


@pytest.mark.cuda
def test_f32_reverse_fused_kernels_match_plain_on_card():
    _need_card()
    model, params, T, x = _f32_setup()
    args = TM._pe_factored(x["pts"], model, T)
    out = {}
    for kind, op in (("kernel", CRF.make_cuda_reverse_fused(model)),
                     ("plain", make_reverse_fused_mlp(model))):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        raw, graw = op(p, *args)
        out[kind] = (p, raw, graw)
    (pk, rk, gk), (pp, rp, gp) = out["kernel"], out["plain"]
    fwd = [_rel(rk, rp)] + [_rel(gk[:, c], gp[:, c]) for c in range(3)]
    print(f"K2-f32: raw, graw {fwd}")
    assert max(fwd) <= TOL_F32_RAW
    draw, dgraw = torch.autograd.grad(_rf_loss(rk, gk), (rk, gk),
                                      retain_graph=True)
    n0 = dict(CRF.LAUNCHES)
    kg = torch.autograd.grad((rk, gk), (pk["Wp"], pk["bp"]), (draw, dgraw))
    assert CRF.LAUNCHES["K3-f32"] == n0["K3-f32"] + 1
    assert CRF.LAUNCHES["K3"] == n0["K3"]
    pg = torch.autograd.grad((rp, gp), (pp["Wp"], pp["bp"]), (draw, dgraw))
    errs = [_rel(a, r) for a, r in zip(_blocks(model, *kg),
                                       _blocks(model, *pg))]
    print(f"K3-f32: blocks {max(errs):.3e}")
    assert max(errs) <= TOL_F32_GRAD, f"gradient blocks: {errs}"


@pytest.mark.cuda
def test_f32_trainer_launches_the_f32_kernel_once_per_step_on_card():
    _need_card()
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config
    cam = Config().camera.__class__(160, 120, 100.0, 100.0, 79.5, 59.5)
    cfg = Config().replace(dataset_format="synthetic", bounds_method="pc",
                           kf_buffer_size=16, camera=cam,
                           mm_precision="highest")
    tr = Trainer(cfg)
    assert tr.fns.kernel_sources == ["train_mlp_f32"]
    tr._per_step_device_s = 1.0 / 300
    n0 = dict(K.LAUNCHES)
    res = train_loop(tr, max_steps=40)
    assert {k: K.LAUNCHES[k] - n0[k] for k in n0} == {
        k: 40 if k == "K1-pc-f32" else 0 for k in n0}
    assert res.steps == 40


def _graph_trainer(eager, **knobs):
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config
    cam = Config().camera.__class__(160, 120, 100.0, 100.0, 79.5, 59.5)
    cfg = Config().replace(dataset_format="synthetic", bounds_method="pc",
                           kf_buffer_size=7, camera=cam, **knobs)
    tr = Trainer(cfg, eager=eager)
    tr._per_step_device_s = 1.0 / 300
    return tr


def _graph_schedule(tr, cuts):
    """Nine keyframes into a 7-row arena (the window branch switches, two
    evictions), then the tail; the per-step total losses."""
    out = []
    for fid in range(0, 90, 10):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([fid])[0])
        for n in cuts:
            out.extend(tr.run_steps(n)["total_loss"].tolist())
    tr.tail_mode, tr.noise_std = True, 0.0
    for n in cuts:
        out.extend(tr.run_steps(n)["total_loss"].tolist())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    {}, dict(pe_in_kernel=False, use_pallas=True),
    dict(grad_mode="reverse_fused", use_pallas=True),
    dict(compute_dtype="bfloat16", grad_mode="auto"),
    dict(n_embed_funcs=8)],
    ids=["K1-pc", "K1-stream+K4", "reverse_fused+K4", "auto-bf16",
         "K1-pc-384"])
def test_graph_route_equals_eager_on_card(knobs):
    """Replays of the captured step give the eager loop's bits, bundles
    cut differently; a kernel's launches count once a step either way."""
    _need_card()
    counts = (K.LAUNCHES, CB.LAUNCHES, CRF.LAUNCHES)
    runs = []
    for eager, cuts in ((True, (5,)), (False, (2, 3))):
        tr = _graph_trainer(eager, **knobs)
        n0 = {k: v for d in counts for k, v in d.items()}
        losses = _graph_schedule(tr, cuts)
        n1 = {k: v for d in counts for k, v in d.items()}
        runs.append((tr, losses, {k: n1[k] - n0[k] for k in n1}))
    (te, le, ne), (tg, lg, ng) = runs
    assert le == lg and ne == ng
    assert all(v in (0, 50) for v in ne.values())
    for a, b in ((te.params, tg.params), (te.opt_state["mu"],
                                          tg.opt_state["mu"])):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(te.buffer.loss_approx, tg.buffer.loss_approx)
    assert tg.fns.graphs.stats["captures"] == 3
    assert tg.fns.graphs.stats["replays"] == 47


@pytest.mark.cuda
def test_graph_bundle_does_not_sync_on_card():
    """A bundle of a captured key runs under the sync debug mode's
    "error": nothing in it waits on the host."""
    _need_card()
    tr = _graph_trainer(False)
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    tr.run_steps(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.fns.train_bundle(tr.params, tr.opt_state, tr.buffer,
                            tr.transform_dev, tr._bundle_seed, 0.04,
                            n_steps=5, step0=tr.steps_taken)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_pose_burst_graph_equals_eager_on_card():
    _need_card()
    from isdf_tpu_torch.engine import pose as P
    tr = _graph_trainer(True, refine_poses=True)
    for fid in (0, 20):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([fid])[0])
    tr.run_steps(30)
    rows = torch.arange(2, device="cuda")
    res = []
    for eager in (True, False):
        ref = P.PoseRefiner(tr.model, n_rays=50, eager=eager)
        gen = torch.Generator(device="cuda").manual_seed(3)
        state, _ = P.init_pose_state(7, device="cuda")
        out = []
        for _ in range(3):
            state, losses = ref(tr.params, state, tr.buffer.depth[rows],
                                tr.buffer.T_WC[rows], rows, tr.fns.dirs,
                                tr.transform_dev, gen, n_steps=4)
            out.append((state.twists.clone(), losses.clone()))
        res.append(out)
    assert all(torch.equal(a, b) for x, y in zip(*res)
               for a, b in zip(x, y))
