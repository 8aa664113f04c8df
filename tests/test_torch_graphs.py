"""The graph route of the port's step and pose burst (engine/step.py,
engine/pose.py, utils/graphs.py) on the CPU.

On the card a bundle is one captured step replayed; here a stand-in for
utils/graphs.GraphRunner keeps its contract (``warm`` runs a function,
``capture`` records it without running it, a replay runs it) so that the
route's own logic runs: the key, the per-step table copied into the
captured step's input, the generator seeded before each replay, the
tensors the graphs were captured on. Its results must equal the eager
loop's bit for bit however the steps are cut into bundles, across keyframe
additions, evictions and the tail switch, on every route of the step. The
card holds the real graphs to the eager loop in chip_smoke.py (phase 10)
and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from isdf_tpu.engine import buffer as JB
from isdf_tpu_torch.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu_torch.engine import buffer as TB
from isdf_tpu_torch.engine.step import step_seed, step_table
from isdf_tpu_torch.engine.trainer import Trainer
from isdf_tpu_torch.utils import nvcc
from isdf_tpu_torch.utils.config import Config as TConfig


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class FakeCaptured:
    def __init__(self, fn, owner):
        self.fn, self.owner, self.tally = fn, owner, []

    def replay(self, times=1):
        for _ in range(times):
            self.fn()
        self.owner.stats["replays"] += times


class FakeRunner:
    """utils/graphs.GraphRunner's contract on the CPU: a capture records
    the function without running it; a replay runs it."""

    def __init__(self):
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        self.generators = []

    def warm(self, fn):
        return fn()

    def capture(self, fn, generators=()):
        self.stats["captures"] += 1
        self.generators.append(tuple(generators))
        return FakeCaptured(fn, self)


def small_cfg(**kw):
    cam = TConfig().camera.__class__(64, 48, 40.0, 40.0, 31.5, 23.5)
    base = dict(dataset_format="synthetic", n_rays=20, n_strat_samples=9,
                n_surf_samples=4, hidden_feature_size=64,
                hidden_layers_block=1, n_embed_funcs=4, kf_buffer_size=7,
                bounds_method="pc", do_eval=False, mm_precision="highest",
                do_active=True, camera=cam, kf_eviction="lowest")
    base.update(kw)
    return TConfig().replace(**base)


DATASET = SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                           n_frames=120, H=48, W=64)


def _trainer(graph, **kw):
    tr = Trainer(small_cfg(**kw), dataset=DATASET, seed=3, device="cpu")
    if graph:
        tr.fns.graphs = FakeRunner()
        tr.fns.eager = False
    return tr


def _state(tr):
    return ([tr.params[k] for k in sorted(tr.params)] + [
        tr.opt_state["count"]] + [tr.opt_state[m][k] for m in ("mu", "nu")
                                  for k in sorted(tr.params)]
        + [tr.buffer.frame_avg_loss, tr.buffer.loss_approx,
           tr.buffer.depth, tr.buffer.frame_id])


def _run(tr, cuts):
    """A schedule through the key changes: frames added one by one past
    the window (count 1..5, then 6 and 7 with the arena full, then two
    evictions), the refinement tail at the end; ``cuts`` the bundle sizes
    of each phase. Returns the per-step scalars in order."""
    logs = []

    def steps():
        for n in cuts:
            s = tr.run_steps(n)
            logs.append(np.stack([s[k] for k in sorted(s)
                                  if k != "step_time_ms"], axis=1))
    for fid in range(0, 90, 10):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([fid])[0])
        steps()
    tr.tail_mode = True
    tr.noise_std, tr.lr_scale = 0.0, 0.4
    steps()
    return np.concatenate(logs)


ROUTES = {
    "K1-pc": {},
    "K1-ray": dict(bounds_method="ray"),
    "K1-stream+K4": dict(pe_in_kernel=False, use_pallas=True),
    "reverse_fused+K4": dict(grad_mode="reverse_fused", use_pallas=True),
    "auto-bf16": dict(grad_mode="auto", bounds_method="ray",
                      compute_dtype="bfloat16"),
    "gauss_embed": dict(gauss_embed=True, bounds_method="ray"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_route_equals_eager_across_bundle_cuts(route):
    """Eager in bundles of 5, the graph route in 2 + 3: the same bits in
    the state and the scalars. One capture per key: (count <= window,
    tail) takes three values in this schedule."""
    kw = ROUTES[route]
    ref, tr = _trainer(False, **kw), _trainer(True, **kw)
    np.testing.assert_array_equal(_run(tr, [2, 3]), _run(ref, [5]))
    for x, y in zip(_state(tr), _state(ref)):
        assert torch.equal(x, y)
    assert tr.buffer.count == ref.buffer.count == 7
    assert tr.fns.graphs.stats["captures"] == 3
    assert tr.fns.graphs.generators == [(tr.fns.gen,)] * 3
    # every step but each key's first is a replay
    assert tr.fns.graphs.stats["replays"] == 10 * 5 - 3


def test_small_arena_keys_on_the_count():
    """An arena smaller than the window (4 < 5): the write-back slices by
    the fill count, so each count is a key of its own."""
    ref, tr = _trainer(False, kf_buffer_size=4), _trainer(True,
                                                         kf_buffer_size=4)
    np.testing.assert_array_equal(_run(tr, [1, 2]), _run(ref, [3]))
    for x, y in zip(_state(tr), _state(ref)):
        assert torch.equal(x, y)
    # counts 1..4, then the tail at count 4
    assert tr.fns.graphs.stats["captures"] == 5


def test_new_tensors_drop_the_graphs(tmp_path):
    """A checkpoint load replaces the parameters, moments and arena: the
    graphs captured on the old tensors are dropped, and the resumed run
    equals the eager one."""
    ref, tr = _trainer(False), _trainer(True)
    for t in (ref, tr):
        t.last_is_keyframe = True
        t.add_frame(t.get_data([0])[0])
        t.run_steps(5)
    path = str(tmp_path / "a.npz")
    tr.save_checkpoint(path)
    assert tr.fns.graphs.stats["captures"] == 1
    tr.load_checkpoint(path)
    ref.load_checkpoint(path)
    tr.run_steps(4)
    ref.run_steps(4)
    assert tr.fns.graphs.stats["captures"] == 2
    assert all(a is b for a, b in zip(tr.fns._captured_on[0][:2],
                                      [tr.params[k]
                                       for k in sorted(tr.params)]))
    for x, y in zip(_state(tr), _state(ref)):
        assert torch.equal(x, y)


def test_step_table_holds_the_eager_steps_values():
    """Row t of the table is what the eager step read as Python numbers
    (noise_std, lr_scale, the fill count), rounded to float32; a step
    given the row equals a step given those numbers as tensors."""
    tab = step_table(4, 0.0123, 0.71, 6, "cpu")
    want = np.float32([0.0123, 0.71, 6.0])
    assert tab.dtype == torch.float32 and tab.shape == (4, 3)
    np.testing.assert_array_equal(tab.numpy(), np.tile(want, (4, 1)))
    outs = []
    for ins in (tab[2], torch.tensor(want)):
        tr = _trainer(False)
        for fid in range(0, 60, 10):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
        tr.fns.gen.manual_seed(step_seed(5, 0))
        sc = tr.fns.core(tr.params, tr.opt_state, tr.buffer,
                         tr.transform_dev, tr.fns.gen, ins, False)
        outs.append((sc, _state(tr)))
    for k in outs[0][0]:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
    for x, y in zip(outs[0][1], outs[1][1]):
        assert torch.equal(x, y)


def test_capture_tally_counts_replays(monkeypatch):
    """A kernel launch captured into a graph counts once per replay, and
    the capture itself launches nothing."""
    counter = {"K": 0}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with nvcc.capture_tally() as tally:
        nvcc.count_launch(counter, "K")
    assert counter["K"] == 0 and tally == [(counter, "K")]
    nvcc.add_tally(tally, 3)
    assert counter["K"] == 3
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    nvcc.count_launch(counter, "K")
    assert counter["K"] == 4


def test_pose_burst_graph_equals_eager():
    """Three bursts over two frames on one generator, then one over one
    frame: replays of the captured burst give the eager bursts' bits (the
    generator's stream advances alike)."""
    outs = []
    for graph in (False, True):
        tr = Trainer(small_cfg(refine_poses=True, pose_iters=3),
                     dataset=DATASET, seed=4, device="cpu")
        for fid in (0, 20):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
        tr.run_steps(20)
        if graph:
            tr._pose_step.graphs = FakeRunner()
        losses = [tr.refine_poses_step(n_frames=2, n_steps=3)
                  for _ in range(3)]
        losses.append(tr.refine_poses_step(n_frames=1, n_steps=3))
        outs.append((losses, tr.pose_state.twists.clone()))
        if graph:
            assert tr._pose_step.graphs.stats == {
                "captures": 2, "capture_s": 0.0, "replays": 2}
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1])


def test_eviction_in_place_matches_isdf_tpu():
    """Evictions at the front, middle and end of the arena: the port's
    compaction in place gives isdf_tpu's arena, and keeps every tensor's
    storage."""
    C, H, W = 6, 5, 7
    rng = np.random.default_rng(11)
    bj = JB.make_buffer(C, H, W)
    bt = TB.make_buffer(C, H, W)
    ptrs = [bt.depth.data_ptr(), bt.normals.data_ptr(), bt.T_WC.data_ptr()]
    import jax.numpy as jnp
    for i in range(C):
        d = rng.random((H, W)).astype(np.float32)
        T = rng.random((4, 4)).astype(np.float32)
        n = rng.random((H, W, 3)).astype(np.float32)
        bj = JB.add_frame(bj, jnp.asarray(d), jnp.asarray(T),
                          jnp.asarray(n), i, False)
        TB.add_frame(bt, torch.from_numpy(d), torch.from_numpy(T),
                     torch.from_numpy(n), i, False)
    for victim in (0, 2, 3):
        prio = rng.random(C).astype(np.float32) + 1.0
        prio[victim] = 0.5
        la = rng.random((C, 8, 8)).astype(np.float32)
        bj = bj._replace(frame_avg_loss=jnp.asarray(prio),
                         loss_approx=jnp.asarray(la))
        bt.frame_avg_loss.copy_(torch.from_numpy(prio))
        bt.loss_approx.copy_(torch.from_numpy(la))
        bj = JB.evict_lowest_priority(bj)
        assert TB.evict_lowest_priority(bt) is bt
        assert bt.count == int(bj.count)
        for f in ("depth", "T_WC", "normals", "frame_avg_loss",
                  "loss_approx", "frame_id"):
            np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                          np.asarray(getattr(bj, f)))
        bj = JB.add_frame(bj, bj.depth[0], bj.T_WC[0], bj.normals[0], 9,
                          False)
        TB.add_frame(bt, bt.depth[0].clone(), bt.T_WC[0].clone(),
                     bt.normals[0].clone(), 9, False)
    assert [bt.depth.data_ptr(), bt.normals.data_ptr(),
            bt.T_WC.data_ptr()] == ptrs


def test_adamw_device_count_matches_isdf_tpu_over_20_steps():
    """AdamW with its step count an int32 tensor and the bias corrections
    computed from it in float32 on the tensors' device (the captured
    step's form), lr_scale a device scalar, against isdf_tpu's
    fused_adamw on optax's state over 20 steps: rtol 1e-5 (float32
    elementwise in another order), the same count."""
    import jax.numpy as jnp
    import optax
    from isdf_tpu.models.fused_adamw import make_fused_adamw as j_adamw
    from isdf_tpu_torch.models import fused_adamw as TA
    rng = np.random.default_rng(12)
    p = {"Wp": rng.normal(size=(3, 8, 4)).astype(np.float32),
         "bp": rng.normal(size=(3, 4)).astype(np.float32)}
    upd_j = j_adamw(1.3e-3, 0.012)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    sj = optax.adamw(1.3e-3, weight_decay=0.012).init(pj)
    upd_t = TA.make_fused_adamw(1.3e-3, 0.012)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    st = TA.init_state(pt)
    assert st["count"].dtype == torch.int32 and st["count"].dim() == 0
    count = st["count"]
    for i in range(20):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        s = 1.0 - 0.04 * i
        pj, sj = upd_j(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj,
                       jnp.float32(s))
        upd_t(pt, {k: torch.from_numpy(v) for k, v in g.items()}, st,
              torch.full((), s))
    assert st["count"] is count and int(count) == int(sj[0].count) == 20
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(st["mu"][k].numpy(),
                                   np.asarray(sj[0].mu[k]), rtol=1e-5)
        np.testing.assert_allclose(st["nu"][k].numpy(),
                                   np.asarray(sj[0].nu[k]), rtol=1e-5)


def test_capture_holds_off_the_cyclic_collector(monkeypatch):
    """GraphRunner.capture disables Python's cyclic collector from
    capture_begin to capture_end and restores it after, also when the
    function raises: a graph the collector frees mid-capture resets, which
    invalidated the capture on the card (CUDA's calls stood in for on the
    CPU, as tests/test_torch_server.py does)."""
    import contextlib
    import gc

    from isdf_tpu_torch.utils import graphs as G

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def register_generator_state(self, gen):
            pass

        def capture_begin(self, pool=None):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    runner = G.GraphRunner("cpu")
    assert gc.isenabled()
    seen = []
    runner.capture(lambda: seen.append(("fn", gc.isenabled())))
    assert seen == [("begin", False), ("fn", False), ("end", False)]
    assert gc.isenabled()

    def fails():
        raise RuntimeError("planted")
    with pytest.raises(RuntimeError, match="planted"):
        runner.capture(fails)
    assert gc.isenabled()
    gc.disable()
    try:
        runner.capture(lambda: None)
        assert not gc.isenabled()
    finally:
        gc.enable()
