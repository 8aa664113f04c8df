"""``tpu.compute_dtype: "bfloat16"`` in the port against isdf_tpu on the CPU
(models/sdf_mlp.py: the PE, the weights and the hidden activations in
bf16, each op rounded to bf16, the output head in float32).

The two packages round in bf16 with different kernels, so the values are
not bit-equal; each test states its tolerance and also requires the
port's bf16 values to lie nearer isdf_tpu's bf16 values than isdf_tpu's
own float32 values do (largest and mean absolute gap), so that the port
computes the bf16 map rather than the float32 one. isdf_tpu's functions
are held jitted, as its trainer and query service run them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.utils import checkpoint as JCK
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils import checkpoint as TCK
from isdf_tpu_torch.utils.config import Config as TConfig


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _gaps(got, want, other):
    """(max, mean) |got - want|, and the same for other, isdf_tpu's
    float32 values."""
    d, o = np.abs(got - want), np.abs(other - want)
    return (d.max(), d.mean()), (o.max(), o.mean())


def _nearer(got, want, other, largest=True):
    """The port nearer isdf_tpu's bf16 values than isdf_tpu's float32 ones:
    by the mean and, with ``largest``, the largest absolute gap, else the
    root mean square."""
    (dm, da), (om, oa) = _gaps(got, want, other)
    if not largest:
        dm = np.sqrt(np.mean((got - want) ** 2))
        om = np.sqrt(np.mean((other - want) ** 2))
    assert dm < om and da < oa, ((dm, da), (om, oa))


def _models(hidden, blocks, **kw):
    jm = JM.SDFModel(hidden_size=hidden, hidden_layers_block=blocks,
                     compute_dtype=jnp.bfloat16, **kw)
    tm = TM.SDFModel(hidden_size=hidden, hidden_layers_block=blocks,
                     compute_dtype="bfloat16", **kw)
    return jm, dataclasses.replace(jm, compute_dtype=jnp.float32), tm


def _points(n=2000, seed=0):
    return np.random.default_rng(seed).uniform(-3, 3, (n, 3)).astype(
        np.float32)


T = np.array([[0.8, -0.6, 0.0, 0.1], [0.6, 0.8, 0.0, -0.2],
              [0.0, 0.0, 1.0, 0.3], [0, 0, 0, 1]], np.float32)


@pytest.mark.parametrize("hidden,blocks", [(32, 1), (256, 2)])
def test_apply_and_sdf_and_grad_match_isdf_tpu_bf16(hidden, blocks):
    """apply: atol 5e-4 (a rare half-ulp tie of a hidden activation rounds
    the other way; mean 2e-6); sdf_and_grad: atol 2e-3 (mean 3e-4: the
    backward's roundings differ more). Both nearer than isdf_tpu's float32
    values."""
    jm, jm32, tm = _models(hidden, blocks)
    pj = JM.init_params(jax.random.PRNGKey(0), jm)
    pt = TM.params_from_jax(pj, tm)
    x = _points()
    xj, Tj = jnp.asarray(x), jnp.asarray(T)

    def run(fn, m):
        return jax.jit(lambda p, x: fn(p, x, m, transform=Tj))(pj, xj)
    yj, yj32 = (np.asarray(run(JM.apply, m)) for m in (jm, jm32))
    yt = TM.apply(pt, torch.from_numpy(x), tm,
                  transform=torch.from_numpy(T)).numpy()
    assert yt.dtype == np.float32
    np.testing.assert_allclose(yt, yj, atol=5e-4)
    assert np.abs(yt - yj).mean() < 2e-6
    _nearer(yt, yj, yj32)
    gj, gj32 = (np.asarray(run(JM.sdf_and_grad, m)[1]) for m in (jm, jm32))
    st, gt = TM.sdf_and_grad(pt, torch.from_numpy(x), tm,
                             transform=torch.from_numpy(T))
    np.testing.assert_array_equal(st.numpy(), yt)
    np.testing.assert_allclose(gt.numpy(), gj, atol=2e-3)
    assert np.abs(gt.numpy() - gj).mean() < 3e-4
    _nearer(gt.numpy(), gj, gj32)


def test_apply_with_noise_bf16():
    """The keyframe test's forward: the bf16 map plus the given noise,
    isdf_tpu's apply_with_noise on the same draws (atol 5e-4)."""
    jm, jm32, tm = _models(32, 1)
    pj = JM.init_params(jax.random.PRNGKey(1), jm)
    pt = TM.params_from_jax(pj, tm)
    x = _points(500, seed=1)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (500,), jnp.float32))
    want, other = (np.asarray(jax.jit(
        lambda p, x: JM.apply_with_noise(p, x, m, key, 0.2))(
            pj, jnp.asarray(x))) for m in (jm, jm32))
    got = TM.apply_with_noise(pt, torch.from_numpy(x), tm, None, 0.2,
                              noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)
    _nearer(got, want, other)


def test_one_autograd_step_bf16():
    """grad_mode "auto" (nested autograd through the MLP: sdf, its spatial
    gradient, the eikonal and cosine losses) with compute_dtype bf16: the
    loss within rtol 1e-3 and every gradient entry within atol 2e-3 +
    rtol 5e-2 of isdf_tpu's, the loss and the gradient nearer than
    isdf_tpu's float32 step (the gradient by its mean and root mean square
    gap; its largest single gap, 5.9e-3, is as large as the float32
    step's, 5.8e-3)."""
    from test_torch_nonfused import (_arena, _cfg, _grad_leaves,
                                     _j_ray_batch_loss)
    from isdf_tpu.engine import buffer as JB
    from isdf_tpu_torch.engine import buffer as TB
    from isdf_tpu_torch.engine.step import StepFunctions
    from test_torch_nonfused import C, H, W, N_RAYS, Wn
    knobs = dict(grad_mode="auto", bounds_method="ray",
                 compute_dtype="bfloat16")
    cfg_j, cfg_t = _cfg(JConfig, **knobs), _cfg(TConfig, **knobs)
    jm = JM.SDFModel(
        embedding_size=cfg_j.embedding_size,
        hidden_size=cfg_j.hidden_feature_size,
        hidden_layers_block=cfg_j.hidden_layers_block,
        scale_output=cfg_j.scale_output, scale_input=cfg_j.scale_input,
        min_deg=0, max_deg=cfg_j.n_embed_funcs, compute_dtype=jnp.bfloat16)
    jm32 = dataclasses.replace(jm, compute_dtype=jnp.float32)
    tm = TM.SDFModel(
        embedding_size=cfg_t.embedding_size,
        hidden_size=cfg_t.hidden_feature_size,
        hidden_layers_block=cfg_t.hidden_layers_block,
        scale_output=cfg_t.scale_output, scale_input=cfg_t.scale_input,
        min_deg=0, max_deg=cfg_t.n_embed_funcs, compute_dtype="bfloat16",
        mm_precision=cfg_t.mm_precision)
    rng = np.random.default_rng(7)
    dirs = np.concatenate([rng.uniform(-0.5, 0.5, (H, W, 2)),
                           np.ones((H, W, 1))], -1).astype(np.float32)
    _, bt = _arena(JB.make_buffer(C, H, W), TB.make_buffer(C, H, W))
    fns = StepFunctions(cfg_t, tm, H, W, torch.as_tensor(dirs), "cpu")
    assert fns.train_op is None and fns.rf_op is None
    pj = JM.init_params(jax.random.PRNGKey(2), jm)
    pt = TM.params_from_jax(pj, tm)
    # one batch of the arena
    R, S = Wn * N_RAYS, cfg_t.n_strat_samples + cfg_t.n_surf_samples
    gen = torch.Generator().manual_seed(5)
    ib = torch.arange(Wn).repeat_interleave(N_RAYS) % bt.count
    ih = torch.randint(0, H, (R,), generator=gen)
    iw = torch.randint(0, W, (R,), generator=gen)
    depth = bt.depth[ib, ih, iw]
    valid = depth != 0.0
    normals = torch.nan_to_num(bt.normals[ib, ih, iw])
    depth_safe = torch.where(valid, depth, 1.0)
    dirs_C = fns.dirs[ih, iw]
    from isdf_tpu_torch.ops import sampling as TS
    pc, z, _, dirs_W = TS.sample_along_rays(
        gen, bt.T_WC[ib], dirs_C, depth_safe, cfg_t.min_depth,
        cfg_t.dist_behind_surf, cfg_t.n_strat_samples, cfg_t.n_surf_samples)
    noise = torch.randn((R * S,), generator=gen) * 0.1
    scalars, _, grads = fns.autograd_loss_and_grad(
        pt, torch.from_numpy(T), pc, z, dirs_C, dirs_W, depth_safe, normals,
        valid, noise)
    b = {k: jnp.asarray(v.numpy()) for k, v in dict(
        pc=pc, z=z, dirs_C=dirs_C, dirs_W=dirs_W, depth=depth_safe,
        normals=normals, valid=valid).items()}
    nz = jnp.asarray(noise.numpy().reshape(R, S))
    outs = []
    for m in (jm, jm32):
        lj, gj = jax.jit(jax.value_and_grad(lambda p: _j_ray_batch_loss(
            cfg_j, m, p, jnp.asarray(T), nz, b)))(pj)
        outs.append((float(lj), _grad_leaves(gj)))
    np.testing.assert_allclose(float(scalars["total_loss"]), outs[0][0],
                               rtol=1e-3)
    assert abs(float(scalars["total_loss"]) - outs[0][0]) < abs(
        outs[1][0] - outs[0][0])
    g_t = _grad_leaves(TM.params_to_jax(dict(zip(("Wp", "bp"), grads)), tm))
    for a, want, other in zip(g_t, outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a, want, atol=2e-3, rtol=5e-2)
    _nearer(np.concatenate([a.ravel() for a in g_t]),
            np.concatenate([a.ravel() for a in outs[0][1]]),
            np.concatenate([a.ravel() for a in outs[1][1]]), largest=False)


def _cfg_small(cls):
    return cls().replace(
        dataset_format="synthetic", n_rays=40, n_strat_samples=7,
        n_surf_samples=3, hidden_feature_size=32, hidden_layers_block=1,
        n_embed_funcs=3, kf_buffer_size=8, compute_dtype="bfloat16")


def _ds():
    return SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                            n_frames=10, H=32, W=48)


def _pts(n=200, seed=8):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, 3)).astype(
        np.float32)


def test_isdf_tpu_bf16_archive_serves_bf16_in_port(tmp_path):
    """isdf_tpu's tests/test_serve.py:162-189 case across packages: a map
    isdf_tpu trained with compute_dtype bf16, its archive served by the
    port from the archive alone and with the config: bf16, SDF within
    atol 2e-5 and gradients within 1e-3 of isdf_tpu's trainer, each nearer
    than the float32 map."""
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.serve import SDFQueryEngine
    tr = JTrainer(_cfg_small(JConfig), dataset=_ds(), seed=5, grid_dim=48)
    assert tr.model.compute_dtype == jnp.bfloat16
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    tr.run_steps(10)
    path = str(tmp_path / "bf16.npz")
    JCK.save_checkpoint(path, tr, step=10)
    pts = _pts()
    want_s, want_g = tr.sdf_fn(pts), tr.grad_fn(pts)
    m32 = dataclasses.replace(tr.model, compute_dtype=jnp.float32)
    other_s = np.asarray(JM.apply(tr.params, jnp.asarray(pts), m32,
                                  transform=tr.transform_dev))
    other_g = np.asarray(JM.sdf_and_grad(tr.params, jnp.asarray(pts), m32,
                                         transform=tr.transform_dev)[1])
    for eng in (SDFQueryEngine.from_checkpoint(path, device="cpu"),
                SDFQueryEngine.from_checkpoint(
                    path, config=_cfg_small(TConfig), device="cpu")):
        assert eng.model.compute_dtype == "bfloat16"
        got_s, got_g = eng.sdf(pts), eng.grad(pts)
        np.testing.assert_allclose(got_s, want_s, atol=2e-5)
        np.testing.assert_allclose(got_g, want_g, atol=1e-3)
        _nearer(got_s, want_s, other_s)
        _nearer(got_g, want_g, other_g)


def test_port_bf16_archive_round_trips(tmp_path):
    """A port map trained with compute_dtype bf16: its archive says
    "bfloat16"; the port serves it with its trainer's bits, and isdf_tpu's
    query engine serves it in bf16 within atol 2e-5 of the port."""
    from isdf_tpu.serve import SDFQueryEngine as JEngine
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.serve import SDFQueryEngine
    tr = Trainer(_cfg_small(TConfig), dataset=_ds(), seed=5, device="cpu")
    assert tr.model.compute_dtype == "bfloat16"
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    tr.run_steps(10)
    path = str(tmp_path / "port_bf16.npz")
    tr.save_checkpoint(path, step=10)
    with np.load(path) as z:
        assert TCK.read_meta(z)["model"]["compute_dtype"] == "bfloat16"
    pts = _pts(seed=9)
    want = tr.sdf_fn(pts)
    eng = SDFQueryEngine.from_checkpoint(path, device="cpu")
    assert eng.model == tr.model
    np.testing.assert_array_equal(eng.sdf(pts), want)
    np.testing.assert_array_equal(eng.grad(pts), tr.grad_fn(pts))
    jeng = JEngine.from_checkpoint(path)
    assert jeng.model.compute_dtype == jnp.bfloat16
    m32 = dataclasses.replace(tr.model, compute_dtype="float32")
    other = TM.apply(tr.params, torch.from_numpy(pts), m32,
                     transform=tr.transform_dev).numpy()
    np.testing.assert_allclose(jeng.sdf(pts), want, atol=2e-5)
    _nearer(want, np.asarray(jeng.sdf(pts)), other)
    # an archive without a compute dtype reads as float32
    assert TCK.model_from_meta({"hidden_size": 32}).compute_dtype == \
        "float32"
