"""Maps whose PE is wider than 256 lanes (n_embed_funcs 8: E = 381, iSDF's
live RealSense configs), on the CPU, each case parametrised over
n_embed_funcs 5 (E = 255) and 8 (E = 381).

* The port's encoder and MLP against isdf_tpu's (non-Pallas, float32):
  2e-5 absolute, as tests/test_torch_model.py holds them.
* The fused train op's plain version (models/cuda_mlp.py::train_op_plain,
  which chip_smoke.py and tests/test_torch_cuda.py hold the kernels to)
  against the benchmark's plain reference (benchmark/reference.py, autograd
  through iSDF's loss), both with float32 products, on a small ray batch:
  the loss sum rtol 2e-5 and each layer's gradient within 1e-4 of its
  largest magnitude, float32 round-off of a hand-derived backward against
  autograd (read: 9.0e-8 and 1.4e-6).
* A Trainer built from the shipped realsense.json takes steps; the
  franka config builds its step.
* The lane checks: K1 takes 384 lanes in its bf16 mode; a 423-lane
  embedding (or another not packed to 256 or 384 rows), or 381 lanes in
  K1's f32 mode, K2/K3 or the query kernel, raises or is refused with the
  limit in the message.
* K1's launch geometry at 384 lanes, and the PE planes it reads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import inputs as I
from benchmark import reference as REF
from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.ops import embedding as JE
from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models import cuda_query as CQ
from isdf_tpu_torch.models import cuda_reverse_fused as CRF
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import embedding as TE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs")
NF = pytest.mark.parametrize("nf", [5, 8], ids=["nf5", "nf8"])
KW = dict(loss_type="L1", trunc_distance=0.29365022, trunc_weight=5.3834402,
          eik_apply_dist=0.1, eik_weight=0.268, grad_weight=0.018,
          orien_loss=False)


def _E(nf):
    return 42 * (nf + 1) + 3


def _transform():
    import scipy.spatial.transform as st
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = st.Rotation.from_euler("xyz", [0.3, -0.2, 1.1]).as_matrix()
    T[:3, 3] = [0.4, -0.2, 0.9]
    return T


@NF
def test_wide_encoder_and_map_match_jax(nf):
    jm = JM.SDFModel(hidden_layers_block=1, embedding_size=_E(nf),
                     max_deg=nf)
    tm = TM.SDFModel(hidden_layers_block=1, embedding_size=_E(nf),
                     max_deg=nf)
    x = (np.random.default_rng(nf).normal(size=(200, 3)) * 1.5
         ).astype(np.float32)
    T = _transform()
    want = np.asarray(JE.positional_encoding(
        jnp.asarray(x), transform=jnp.asarray(T), scale=0.05937489,
        min_deg=0, max_deg=nf))
    got = TE.positional_encoding(torch.as_tensor(x), torch.as_tensor(T),
                                 scale=0.05937489, min_deg=0, max_deg=nf)
    assert got.shape == (200, _E(nf))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    pj = JM.init_params(jax.random.PRNGKey(nf), jm)
    pt = TM.params_from_jax(pj, tm)
    assert pt["Wp"].shape == (5, 2 * tm.pack_rows, 256)
    sj, gj = JM.sdf_and_grad(pj, jnp.asarray(x), jm, transform=jnp.asarray(T))
    st_, gt = TM.sdf_and_grad(pt, torch.as_tensor(x), tm,
                              transform=torch.as_tensor(T))
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj), atol=2e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-5)


def _ray_batch(R=24, S=9, seed=3):
    """Rays from points near the origin, the surface sample first, with
    iSDF's ray bounds and gradient targets (-d, the first sample's normal),
    noise and a few invalid rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = rng.uniform(1.0, 2.5, R)
    z = np.sort(rng.uniform(0.07, 1.0, (R, S)) * (depth[:, None] + 0.1), 1)
    z[:, 0] = depth
    nrm = rng.normal(size=(R, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    gt = np.repeat(-d[:, None], S, 1)
    gt[:, 0] = nrm
    f = dict(pts=o[:, None] + d[:, None] * z[..., None],
             bounds=depth[:, None] - z, gt=gt,
             valid=np.repeat((rng.random(R) > 0.15)[:, None], S, 1),
             noise=rng.normal(size=(R, S)) * 0.04)
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
            f.items()}


def _ref_loss_and_grads(layers, T, mp, b):
    """iSDF's loss of the batch by autograd through the reference map:
    free space / truncation L1, gradient cosine, gated eikonal; (sum of
    the per-point losses, their count, gradients [(dw, db)])."""
    leaves = [(w.clone().requires_grad_(True), bb.clone().requires_grad_(True))
              for w, bb in layers]
    with torch.enable_grad():
        xg = b["pts"].clone().requires_grad_(True)
        s = REF.sdf(leaves, xg, T, mp)
        (sg,) = torch.autograd.grad(s.sum(), xg, create_graph=True)
        s = s + b["noise"] * mp.scale_output
        bnd = b["bounds"]
        free = bnd > KW["trunc_distance"]
        fs = torch.maximum(torch.relu(s - bnd), torch.exp(-5.0 * s) - 1.0)
        mat = torch.where(free, fs, (s - bnd).abs() * KW["trunc_weight"])
        gl = 1.0 - REF.cos_sim(b["gt"], sg)
        eik = torch.where(bnd < KW["eik_apply_dist"], 0.0,
                          (sg.norm(dim=-1) - 1.0).abs()) * KW["eik_weight"]
        tot = (mat + KW["grad_weight"] * gl + eik) * b["valid"]
        count = b["valid"].sum()
        grads = torch.autograd.grad(tot.sum() / count,
                                    [p for wb in leaves for p in wb])
    return (float(tot.detach().sum()), float(count),
            [(grads[2 * i], grads[2 * i + 1]) for i in range(len(leaves))])


@NF
@pytest.mark.parametrize("stream", [False, True], ids=["ray", "stream"])
def test_train_op_plain_matches_the_plain_reference(nf, stream):
    cfg = {"model": {"embedding": {"n_embed_funcs": nf, "scale_input": 0.04},
                     "hidden_feature_size": 256, "hidden_layers_block": 1,
                     "scale_output": 0.14}}
    mp = REF.Map(cfg)
    assert mp.E == _E(nf)
    model = TM.SDFModel(embedding_size=mp.E, max_deg=nf,
                        hidden_layers_block=1, scale_input=0.04,
                        mm_precision="highest")
    layers = I.make_weights(nf, mp.E, mp.H, mp.blocks, "cpu")
    params = TM.params_from_jax(I.as_tree(layers, mp.blocks), model)
    T = torch.as_tensor(_transform())
    b = _ray_batch()
    N = b["bounds"].numel()
    flat = {k: v.reshape(N, -1).squeeze(-1).contiguous()
            for k, v in b.items()}
    flat["pts"] = b["pts"].reshape(N, 3)
    flat["gt"] = b["gt"].reshape(N, 3)
    inv = torch.tensor(1.0 / float(flat["valid"].sum()))
    op = K.make_train_op(model, **KW, pe_in_kernel=not stream)
    if stream:
        pe, _, dxs, dproj2 = TM._pe_factored(flat["pts"], model, T)
        sums, ploss, (dW, db) = op(params, pe, dxs, dproj2, flat["bounds"],
                                   flat["valid"], flat["noise"], flat["gt"],
                                   inv)
    else:
        sums, ploss, (dW, db) = op(params, T, flat["pts"], flat["bounds"],
                                   flat["valid"], flat["noise"], flat["gt"],
                                   inv)
    total, count, ref = _ref_loss_and_grads(layers, T, mp, b)
    assert float(sums[4]) == count
    np.testing.assert_allclose(float(sums[0]), total, rtol=2e-5)
    assert dW.shape == (5, 2 * model.pack_rows, 256)
    got = TM.unpack({"Wp": dW, "bp": db}, model)
    for (gw, gb), (rw, rb) in zip(got, ref):
        for g, r in ((gw, rw), (gb, rb)):
            assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
    # the padded rows of the packed planes stay exactly zero
    E, Kp = model.embedding_size, model.pack_rows
    assert torch.all(dW[0, E:] == 0) and torch.all(dW[1, 256:] == 0)
    assert torch.all(dW[model.cat_idx, Kp + E:] == 0)


def _views(cfg, n, H=48, W=64, seed=17):
    from benchmark.trainers import Views
    room = I.Room(seed)
    f = 32.0
    cam = dict(H=H, W=W, fx=f, fy=f, cx=(W - 1) / 2, cy=(H - 1) / 2)
    poses = room.poses(n)
    dirs = I.ray_dirs_C(H, W, f, f, cam["cx"], cam["cy"], "cpu")
    depth = room.render(torch.as_tensor(poses), dirs, cfg.max_depth).numpy()
    return Views(depth, poses, cam, room)


@pytest.mark.parametrize("name", ["realsense", "realsense_franka"])
def test_live_configs_train_as_shipped_on_the_cpu(name):
    """The shipped live configs (E = 381) on the fused op's route: three
    steps of the realsense map from rendered views at a small camera; the
    franka map's step is built."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(CONFIGS, name + ".json")).replace(
        kf_buffer_size=6, n_rays=20)
    assert cfg.n_embed_funcs == 8 and cfg.grad_mode == "pallas"
    tr = Trainer(cfg, dataset=_views(cfg, 6), seed=5, device="cpu")
    assert tr.model.embedding_size == 381 and tr.model.pack_rows == 384
    assert tr.fns.train_op is not None and tr.fns.bundle_counts == {}
    if name != "realsense":
        return
    torch.manual_seed(0)
    for i in range(3):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([i])[0])
    before = tr.params["Wp"].clone()
    losses = tr.run_steps(3)["total_loss"]
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert not torch.equal(before, tr.params["Wp"])
    assert all(v == 0 for v in K.LAUNCHES.values())  # CPU: no kernel


def _model(nf, **kw):
    return TM.SDFModel(embedding_size=_E(nf), max_deg=nf, **kw)


def test_k1_takes_384_lanes_and_the_other_kernels_256():
    K.check_k1_model(_model(5))
    K.check_k1_model(_model(8))
    assert K.pe_lanes(_model(5)) == 256 and K.pe_lanes(_model(8)) == 384
    assert K.source("train_mlp", _model(8)) == "train_mlp_384"
    assert K.source("train_mlp", _model(5)) == "train_mlp"
    assert K.variant("K1-ray", _model(8)) == "K1-ray/384"
    assert K.variant("K1-pc", _model(5, mm_precision="highest")) \
        == "K1-pc-f32/256"
    assert {"K1-pc-384", "K1-ray-384", "K1-stream-384"} <= set(K.LAUNCHES)
    for nf in (6, 7, 9):   # packed to 304, 352, 432 rows
        with pytest.raises(ValueError, match=f"369 to 384 lanes.*{_E(nf)}"):
            K.check_k1_model(_model(nf))
    with pytest.raises(ValueError, match="f32-product mode.*at most 256"):
        K.check_k1_model(_model(8, mm_precision="highest"))
    model = _model(8)
    params = TM.init_params(torch.Generator().manual_seed(0), model)
    pe = torch.zeros((64, 381))
    with pytest.raises(ValueError, match="K2/K3.*at most 256 lanes"):
        CRF.rf_forward_cuda(params, model, pe, torch.zeros((3, 384)))
    assert not CQ.supports(model, "cuda")
    assert CQ.supports(_model(5), "cuda")


@pytest.mark.parametrize("N", [27000, 5373])
def test_k1_geometry_at_384_lanes(N):
    """The 384-lane build: the PE's planes and layer 0's and the skip
    layer's pe rows 384 wide, k_dw's grid of six 128x128 tiles a GEMM; in
    shared memory the 256-lane budget, two blocks an SM: X and X2 of the
    PE's first 256 lanes and a ring of two stages, each a transposed slab
    [256][40] or, where a product reads the lanes past 256, the unpadded
    plain slab [32][256] and the A slab [64][32] of those lanes."""
    L = 7
    g = K.k1_geometry(N, L, lanes=384)
    base = K.k1_geometry(N, L)
    NP = g["NP"]
    assert g["shapes"]["pe32"] == g["shapes"]["peb"] == (NP, 384)
    assert g["shapes"]["m0b"] == (NP, 384)
    assert g["shapes"]["part_dw"] == (16, L, 384, 256)
    assert g["shapes"]["dW"] == (L, 768, 256)
    for k in ("sig", "u", "h5", "hb", "tb", "dzb", "dub", "part_db"):
        assert g["shapes"][k] == base["shapes"][k]
    assert g["ldx"] == base["ldx"] == 264
    assert g["stage"] == base["stage"] == 256 * 40 * 2
    assert (g["wslab"], g["aslab"], base["aslab"]) == (16384, 4096, 0)
    assert g["wslab"] + g["aslab"] == g["stage"]
    assert g["smem"] == base["smem"] == 2 * 64 * 264 * 2 + 2 * 20480 \
        == 108544
    # each of two blocks: dynamic, static and the 1 KB the SM reserves
    assert g["smem"] + g["smem_static"] + 1024 <= 116736
    assert g["blocks_per_sm"] == 2 and base["blocks_per_sm"] == 2
    assert g["dw_tiles"] == 6 and base["dw_tiles"] == 4
    assert g["smem_dw"] == base["smem_dw"]
    with pytest.raises(AssertionError):
        K.k1_geometry(N, L, f32=True, lanes=384)


def test_wide_pe_planes_span_384_lanes():
    """The PE constants and tangent rows of a 381-lane map span the 384
    lanes the kernel reads, zero past the embedding."""
    model = _model(8)
    Tc = K.tangent_rows(model, torch.eye(3), torch.ones((3, 378)))
    assert Tc.shape == (3, 384) and torch.all(Tc[:, 381:] == 0)
    M, _, _ = TM._pe_consts(model, None)
    assert M.shape == (128, 384) and torch.all(M[:, 381:] == 0)
