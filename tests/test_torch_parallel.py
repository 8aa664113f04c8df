"""Data parallelism of the port (parallel/mesh.py, the sharded step of
engine/step.py, Trainer's tpu.data_parallel) against isdf_tpu's on the CPU.

isdf_tpu runs its mesh on 8 virtual CPU devices (tests/conftest.py); the
port's mesh repeats the one CPU device 8 times, each shard's work launched
in turn and its sums added in shard order.

* The mesh helpers: contiguous shards, one replica per distinct device,
  the fixed-order sum equal in bits to a sequential sum, the raises.
* One sharded step on the same draws against isdf_tpu's
  build_step_functions(mesh=make_mesh(8)) (its Pallas op in interpret
  mode under shard_map), on both fused routes and the non-fused one: loss
  scalars rtol 2e-5; the gradient atol 1e-5 + rtol 2e-3 (the fused op's
  against isdf_tpu's op under shard_map on the same operands, the
  non-fused step's against isdf_tpu's loss composed from its public
  functions); updated weights atol 1e-6 where |grad| > 1e-5; priorities
  rtol 1e-5. The unsharded counterparts' limits
  (tests/test_torch_nonfused.py, tests/test_torch_slice.py).
* The step at dp = 1: a mesh of one shard, whose gathers and sums hand
  back the op's own tensors (no copy kernel), on both fused routes and
  the autograd one.
* The trainer: tests/test_torch_parallel_trainer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.engine import buffer as JB
from isdf_tpu.engine.step import build_step_functions
from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.models.pallas_mlp import (make_pallas_train_op, pack_params_train,
                                        unpack_params_train)
from isdf_tpu.parallel.mesh import make_mesh as j_make_mesh
from isdf_tpu.parallel.mesh import replicated
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.engine import buffer as TB
from isdf_tpu_torch.engine.step import StepFunctions, select_window
from isdf_tpu_torch.models import fused_adamw as TA
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import sampling as TS
from isdf_tpu_torch.parallel import mesh as PM
from isdf_tpu_torch.utils.config import Config as TConfig
from test_torch_nonfused import (C, H, N_RAYS, W, Wn, _arena, _grad_leaves,
                                 _j_ray_batch_loss, _model, _tensors,
                                 _transform)

D = 8   # shards: isdf_tpu's 8 virtual devices


@pytest.fixture(autouse=True)
def _two_threads():
    """torch on 2 threads: with several test processes on the machine,
    one spinning thread per core slows concurrent runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ mesh helpers

def test_split_cuts_contiguous_views_in_shard_order():
    mesh = PM.make_mesh(devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(12, 2)
    y = torch.arange(12)
    shards = PM.split(mesh, x, y)
    assert len(shards) == 4
    for k, (xs, ys) in enumerate(shards):
        assert torch.equal(ys, torch.arange(3 * k, 3 * k + 3))
        assert xs.data_ptr() == x[3 * k].data_ptr()   # a view, no copy
    with pytest.raises(ValueError, match="divide"):
        PM.split(mesh, torch.zeros(10))


def test_one_replica_per_distinct_device():
    mesh = PM.make_mesh(devices=["cpu"] * D)
    assert mesh.size == D and mesh.distinct == [torch.device("cpu")]
    t = torch.ones(3)
    reps = PM.replicate(mesh, t)
    assert list(reps) == [torch.device("cpu")] and reps[mesh.first] is t
    p = {"Wp": torch.zeros(2, 2), "bp": torch.zeros(2)}
    rp = PM.replicate(mesh, p)[mesh.first]
    assert all(rp[k] is p[k] for k in p)


def test_fixed_sum_is_a_sequential_sum_in_shard_order():
    mesh = PM.make_mesh(devices=["cpu"] * D)
    rng = np.random.default_rng(0)
    # magnitudes far apart, so that another order gives other bits
    parts = [torch.as_tensor(rng.normal(size=(64,)).astype(np.float32)
                             * 10.0 ** (k % 4 * 3)) for k in range(D)]
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    assert torch.equal(PM.fixed_sum(mesh, parts), acc)
    rev = parts[-1].clone()
    for p in parts[-2::-1]:
        rev = rev + p
    assert not torch.equal(acc, rev)


def test_make_mesh_and_block_devices():
    with pytest.raises(RuntimeError, match=r"device\(s\) visible"):
        PM.make_mesh(2)
    with pytest.raises(ValueError, match="2 devices given"):
        PM.make_mesh(3, devices=["cpu", "cpu"])
    mesh = PM.make_mesh(axis="scene", devices=["cpu", "meta"])
    assert mesh.axis == "scene"
    assert [d.type for d in PM.block_devices(mesh, 4)] == \
        ["cpu", "cpu", "meta", "meta"]
    with pytest.raises(ValueError, match="divide"):
        PM.block_devices(mesh, 3)
    assert PM.parse_devices("cuda:0, cuda:0") == ["cuda:0", "cuda:0"]
    assert PM.parse_devices("cpu") == "cpu" and PM.parse_devices(None) is None


# ------------------------------------------------------- one sharded step

ROUTES = {
    "fused-ray": dict(bounds_method="ray"),
    "fused-pc": dict(bounds_method="pc"),
    "nonfused-K2K3-pc": dict(bounds_method="pc", pe_in_kernel=False,
                             use_pallas=True, hidden_feature_size=64,
                             n_embed_funcs=3),
}


def _cfg(cls, **kw):
    base = dict(hidden_layers_block=1, window_size=Wn, n_rays=N_RAYS,
                n_strat_samples=6, n_surf_samples=3, kf_buffer_size=C,
                do_active=False, mm_precision="highest", grad_mode="pallas",
                pallas_interpret=True)
    base.update(kw)
    return cls().replace(**base)


def _j_sharded_op(op, mesh, sharded, *args):
    """isdf_tpu's _shard_mapped (step.py:285-305) around its op."""
    from jax.sharding import PartitionSpec as PS

    def local(*a):
        s, pls, g = op(*a)
        return (jax.lax.psum(s, "dp"), pls,
                jax.tree_util.tree_map(lambda x: jax.lax.psum(x, "dp"), g))
    specs = tuple(PS("dp") if i in sharded else PS()
                  for i in range(len(args)))
    return jax.shard_map(local, mesh=mesh, in_specs=specs,
                         out_specs=(PS(), PS("dp"), PS()),
                         check_vma=False)(*args)


@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_step_matches_jax_sharded_step(route):
    knobs = ROUTES[route]
    cfg_j, cfg_t = _cfg(JConfig, **knobs), _cfg(TConfig, **knobs)
    jm, tm = _model(cfg_j, JM), _model(cfg_t, TM)
    fused = cfg_t.pe_in_kernel
    T = _transform()
    rng = np.random.default_rng(7)
    dirs = np.concatenate([rng.uniform(-0.5, 0.5, (H, W, 2)),
                           np.ones((H, W, 1))], -1).astype(np.float32)
    pj = JM.init_params(jax.random.PRNGKey(2), jm)
    bj, bt = _arena(JB.make_buffer(C, H, W), TB.make_buffer(C, H, W))
    key, noise_std, lr_scale = jax.random.PRNGKey(5), 0.1, 0.8

    # ---- the batch isdf_tpu's step draws, from its own keys ----
    k_sel, k_pix, k_ray, k_noise = jax.random.split(
        jax.random.fold_in(key, 0), 4)
    kh, kw = jax.random.split(k_pix)
    R = Wn * N_RAYS
    S = cfg_t.n_strat_samples + cfg_t.n_surf_samples
    ih, iw = (jax.random.randint(kh, (R,), 0, H),
              jax.random.randint(kw, (R,), 0, W))
    k_strat, k_surf = jax.random.split(k_ray)
    draws = _tensors(jax.random.uniform(k_strat, (R, cfg_t.n_strat_samples)),
                     jax.random.normal(k_surf, (R, cfg_t.n_surf_samples - 1)))
    noise = np.array(jax.random.normal(k_noise, (R * S,) if fused
                                       else (R, S)) * noise_std)

    # ---- isdf_tpu_torch on that batch, sharded over 8 CPU shards ----
    mesh = PM.make_mesh(devices=["cpu"] * D)
    fns = StepFunctions(cfg_t, tm, H, W, torch.as_tensor(dirs), "cpu",
                        mesh=mesh)
    assert (fns.train_op is not None) == fused
    assert (fns.rf_op is not None) != fused
    pt = TM.params_from_jax(pj, tm)
    opt_t = TA.init_state(pt)
    idxs, slot_valid = select_window(None, bt.count, bt.frame_avg_loss, Wn,
                                     g=torch.zeros(C))
    ib = torch.arange(Wn).repeat_interleave(N_RAYS)
    ih_t, iw_t = _tensors(ih, iw)
    gi = idxs[ib]
    depth = bt.depth[gi, ih_t, iw_t]
    valid = (depth != 0.0) & slot_valid[ib]
    normals = bt.normals[gi, ih_t, iw_t]
    valid &= ~torch.isnan(normals[..., 0])
    normals = torch.nan_to_num(normals)
    depth_safe = torch.where(valid, depth, 1.0)
    dirs_C = fns.dirs[ih_t, iw_t]
    pc, z, _, dirs_W = TS.sample_along_rays(
        None, bt.T_WC[gi], dirs_C, depth_safe, cfg_t.min_depth,
        cfg_t.dist_behind_surf, cfg_t.n_strat_samples, cfg_t.n_surf_samples,
        draws=draws)
    surf, sv = fns.surf_set(None, pc, valid)
    seen = []
    if fused:
        inner = fns._shard_mapped
        fns._shard_mapped = lambda op, sh, *a: (seen.append((sh, a))
                                                or inner(op, sh, *a))
    scalars, ploss, grads = fns.loss_and_grad(
        pt, torch.as_tensor(T), pc, z, dirs_C, dirs_W, depth_safe, normals,
        valid, torch.as_tensor(noise).reshape(-1), surf=surf, sv=sv)
    g_plane = [g.clone() for g in grads]
    fns.update(pt, opt_t, bt, grads, ploss, idxs, slot_valid, ib, ih_t,
               iw_t, valid, lr_scale)

    # ---- isdf_tpu: its sharded step on the same keys ----
    jmesh = j_make_mesh(D)
    rep = replicated(jmesh)
    # copies: the bundle donates its state
    put = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jax.device_put(jnp.copy(x), rep), t)
    fj = build_step_functions(cfg_j, jm, H, W, jnp.asarray(dirs),
                              mesh=jmesh)
    assert fj.uses_pallas_kernel == fused
    pj2, _, bj2, sc_j = fj.train_bundle(
        put(pj), put(fj.optimiser.init(pj)), put(bj),
        jax.device_put(fj.dirs, rep), put(jnp.asarray(T)), key,
        noise_std, n_steps=1, lr_scale=lr_scale)

    assert sorted(scalars) == sorted(sc_j)
    for k in scalars:
        np.testing.assert_allclose(float(scalars[k]), float(sc_j[k][0]),
                                   rtol=2e-5, atol=1e-9, err_msg=k)
    if fused:
        # the op's gradient against isdf_tpu's op under shard_map, on the
        # operands the port's step gave its own
        (sharded, args), = seen
        op = make_pallas_train_op(
            jm, 1, loss_type=cfg_j.loss_type,
            trunc_distance=cfg_j.trunc_distance,
            trunc_weight=cfg_j.trunc_weight,
            eik_apply_dist=cfg_j.eik_apply_dist, eik_weight=cfg_j.eik_weight,
            grad_weight=cfg_j.grad_weight, orien_loss=cfg_j.orien_loss,
            interpret=True, force_f32=True, pe_in_kernel=True,
            pc_bounds=cfg_j.bounds_method == "pc", packed_io=True)
        ja = [pack_params_train(pj)] + [jnp.asarray(a.numpy())
                                        for a in args[1:]]
        _, ploss_j, (dW_j, dbt_j) = _j_sharded_op(op, jmesh, sharded, *ja)
        np.testing.assert_allclose(g_plane[0].numpy(), np.asarray(dW_j),
                                   atol=1e-5, rtol=2e-3)
        np.testing.assert_allclose(g_plane[1].numpy().reshape(-1),
                                   np.asarray(dbt_j)[0], atol=1e-5,
                                   rtol=2e-3)
        np.testing.assert_allclose(ploss.numpy().reshape(-1),
                                   np.asarray(ploss_j), rtol=1e-5, atol=1e-7)
        g_j = unpack_params_train(pj, dW_j, dbt_j)
    else:
        b = {k: jnp.asarray(v.numpy()) for k, v in dict(
            pc=pc, z=z, dirs_C=dirs_C, dirs_W=dirs_W, depth=depth_safe,
            normals=normals, valid=valid).items()}
        g_j = jax.grad(lambda p: _j_ray_batch_loss(
            cfg_j, jm, p, jnp.asarray(T), noise, b))(pj)
        g_t = TM.params_to_jax(dict(zip(("Wp", "bp"), g_plane)), tm)
        for a, gj in zip(_grad_leaves(g_t), _grad_leaves(g_j)):
            np.testing.assert_allclose(a, gj, atol=1e-5, rtol=2e-3)
    p_t = TM.params_to_jax(pt, tm)
    for a, pj_, gj in zip(_grad_leaves(p_t), _grad_leaves(pj2),
                          _grad_leaves(g_j)):
        sure = np.abs(gj) > 1e-5
        np.testing.assert_allclose(a[sure], pj_[sure], atol=1e-6)
    np.testing.assert_allclose(bt.frame_avg_loss.numpy(),
                               np.asarray(bj2.frame_avg_loss), rtol=1e-5)
    np.testing.assert_allclose(bt.loss_approx.numpy(),
                               np.asarray(bj2.loss_approx), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------- the step at dp = 1

ONE_SHARD = {
    "fused-pc": dict(bounds_method="pc"),
    "fused-ray": dict(bounds_method="ray"),
    "autograd": dict(bounds_method="pc", grad_mode="auto"),
}


@pytest.mark.parametrize("route", list(ONE_SHARD))
def test_one_shard_step_returns_the_ops_own_tensors(route, monkeypatch):
    """Without a mesh the step runs on a mesh of one shard, and what it
    gathers and sums over that shard is the op's own output, uncopied:
    the fused op's ploss and gradients, or the autograd route's forward
    (sdf and spatial gradient) and parameter gradients. ``torch.cat`` of
    one tensor copies it, which would add a kernel to every step."""
    cfg = _cfg(TConfig, **ONE_SHARD[route])
    tm = _model(cfg, TM)
    rng = np.random.default_rng(7)
    dirs = np.concatenate([rng.uniform(-0.5, 0.5, (H, W, 2)),
                           np.ones((H, W, 1))], -1).astype(np.float32)
    fns = StepFunctions(cfg, tm, H, W, torch.as_tensor(dirs), "cpu")
    assert isinstance(fns.mesh, PM.Mesh) and fns.mesh.size == 1
    assert fns.mesh.first == torch.device("cpu")
    fused = route != "autograd"
    assert (fns.train_op is not None) == fused

    made, gathered, given = [], [], []

    def spy(f, into):
        def g(*a, **k):
            out = f(*a, **k)
            into.append(out)
            return out
        return g
    if fused:
        fns.train_op = spy(fns.train_op, made)
    else:
        fns._value_and_spatial_grad = spy(fns._value_and_spatial_grad, made)
        fns.value_and_spatial_grad = spy(fns.value_and_spatial_grad,
                                         gathered)
        grads_made = []
        monkeypatch.setattr(torch.autograd, "grad",
                            spy(torch.autograd.grad, grads_made))
    fns.update = lambda p, o, b, grads, ploss, *rest: given.append(
        (grads, ploss))

    _, bt = _arena(JB.make_buffer(C, H, W), TB.make_buffer(C, H, W))
    gen = torch.Generator().manual_seed(3)
    pt = TM.init_params(gen, tm)
    ins = torch.tensor([0.1, 1.0, float(bt.count)])
    fns.core(pt, TA.init_state(pt), bt, torch.as_tensor(_transform()), gen,
             ins, tail=False)

    (grads, ploss), = given
    ptr = [t.data_ptr() for t in grads]
    if fused:
        (_, ploss_k, grads_k), = made
        assert ploss.data_ptr() == ploss_k.data_ptr()
        assert ptr == [t.data_ptr() for t in grads_k]
    else:
        (fwd,), (out,) = made, gathered
        assert [t.data_ptr() for t in out] == [t.data_ptr() for t in fwd]
        # the last autograd call is the parameter gradient's
        assert ptr == [t.data_ptr() for t in grads_made[-1]]
