"""Data parallelism of the port's Trainer (tpu.data_parallel, engine/
trainer.py; the sharded step itself is tests/test_torch_parallel.py's) on
the CPU: dp = 8 against dp = 1 within rtol 2e-4, atol 1e-5, the bounds of
isdf_tpu's tests/test_parallel.py; its raises, isdf_tpu's words; the pose
burst on a dp trainer; and the graph route of a 2-shard mesh giving the
eager loop's bits."""

import numpy as np
import pytest
import torch

from isdf_tpu_torch.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu_torch.engine.trainer import Trainer
from isdf_tpu_torch.utils.config import Config as TConfig
from test_torch_graphs import FakeRunner

D = 8   # shards: isdf_tpu's 8 virtual devices


@pytest.fixture(autouse=True)
def _two_threads():
    """torch on 2 threads: with several test processes on the machine,
    one spinning thread per core slows concurrent runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the trainer

def _base(**kw):
    base = dict(dataset_format="synthetic", n_rays=16, n_strat_samples=5,
                n_surf_samples=3, hidden_feature_size=32,
                hidden_layers_block=1, n_embed_funcs=3, kf_buffer_size=8,
                mm_precision="highest")
    base.update(kw)
    return TConfig().replace(**base)


def _frames_and_steps(tr, n_frames=2, steps=3):
    for i in range(n_frames):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([i])[0])
    return tr.run_steps(steps)


@pytest.mark.parametrize("knobs", [{}, dict(pe_in_kernel=False)],
                         ids=["fused-pc", "nonfused"])
def test_trainer_data_parallel_matches_single_device(knobs):
    """tests/test_parallel.py:118-139 in the port. pe_in_kernel=False takes
    the non-fused route at dp = 8 (the reverse-fused op per shard) and the
    streamed-PE fused op at dp = 1, as isdf_tpu gates them."""
    losses = []
    for dp in (1, D):
        ds = SyntheticDataset(SyntheticScene(), n_frames=10, H=24, W=32)
        tr = Trainer(_base(data_parallel=dp, **knobs), dataset=ds, seed=3,
                     device="cpu")
        assert (tr.mesh is None) == (dp == 1)
        if dp > 1:
            assert tr.mesh.size == D and tr.mesh.first == tr.device
            assert (tr.fns.train_op is None) == ("pe_in_kernel" in knobs)
        losses.append(_frames_and_steps(tr)["total_loss"])
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-4, atol=1e-5)


def test_trainer_data_parallel_raises():
    ds = SyntheticDataset(SyntheticScene(), n_frames=4, H=24, W=32)
    # 75 rays do not divide over 8 shards (tests/test_parallel.py:142-153)
    with pytest.raises(ValueError, match="divide"):
        Trainer(_base(n_rays=15, data_parallel=D), dataset=ds, device="cpu")
    # the cards: this machine has none (isdf_tpu trainer.py:138-141)
    with pytest.raises(RuntimeError, match=r"but only 0 device\(s\) visible"):
        Trainer(_base(data_parallel=2), dataset=ds)
    with pytest.raises(ValueError, match="3 devices given"):
        Trainer(_base(data_parallel=2), dataset=ds, device=["cpu"] * 3)
    tr = Trainer(_base(data_parallel=2), dataset=ds, device=["cpu", "cpu"])
    assert tr.mesh.devices == (torch.device("cpu"),) * 2


def test_pose_burst_on_a_data_parallel_trainer():
    """__graft_entry__.py:96-101: a burst on the newest frame, folded into
    the arena, then the sharded step on the corrected poses."""
    ds = SyntheticDataset(SyntheticScene(), n_frames=10, H=24, W=32)
    tr = Trainer(_base(data_parallel=D, refine_poses=True), dataset=ds,
                 seed=0, device="cpu")
    s = _frames_and_steps(tr, n_frames=3, steps=2)
    assert np.isfinite(s["total_loss"]).all()
    T0 = tr.buffer.T_WC.clone()
    loss = tr.refine_poses_step(n_frames=1, n_steps=2)
    assert np.isfinite(loss)
    tr.apply_pose_corrections()
    assert torch.equal(tr.buffer.T_WC[:2], T0[:2])
    assert np.isfinite(tr.run_steps(1)["total_loss"]).all()


def test_graph_route_of_a_two_shard_mesh_gives_eager_bits():
    """Shards that share a device are captured as one: the CPU stand-in
    runner (tests/test_torch_graphs.py) against the eager loop, the steps
    cut into other bundles, through keyframe additions, evictions and the
    tail."""
    from test_torch_graphs import DATASET, _run, _state, small_cfg
    out = []
    for graph, cuts in ((False, (7,)), (True, (2, 5))):
        tr = Trainer(small_cfg(data_parallel=2), dataset=DATASET, seed=3,
                     device=["cpu", "cpu"])
        if graph:
            tr.fns.graphs = FakeRunner()
            tr.fns.eager = False
        out.append((_run(tr, cuts), _state(tr)))
        if graph:
            assert tr.fns.graphs.stats["captures"] >= 3
    (la, sa), (lb, sb) = out
    assert np.array_equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
