"""The port's SDF query service (isdf_tpu_torch/serve.py) on the CPU, the
cases of tests/test_serve.py against the port: the engine against the
trainer's own queries, the multi-chunk path, costs and collision, input
validation, checkpoint-only loading (the port's archives and isdf_tpu's),
refresh, the HTTP routes, a fleet of maps and the ensemble. Values that
take the same float32 path are compared within 1e-6 (1e-5 through JSON,
gradients 1e-5 / 1e-4); against isdf_tpu's engine, two MLPs' round-off:
rtol 1e-5, atol 1e-6."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from isdf_tpu_torch.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu_torch.eval.metrics import chomp_cost, linear_cost
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.serve import (EnsembleEngine, SDFQueryEngine,
                                  SDFQueryServer)
from isdf_tpu_torch.utils.config import Config

from test_torch_slice import _small


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg():
    return _small(Config).replace(hidden_feature_size=32, kf_buffer_size=8)


@pytest.fixture(scope="module")
def trained():
    from isdf_tpu_torch.engine.trainer import Trainer
    scene = SyntheticScene(extents=(5.0, 3.0, 4.0))
    ds = SyntheticDataset(scene, n_frames=20, H=24, W=32)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    tr = Trainer(_cfg(), dataset=ds, seed=3, device="cpu", grid_dim=8)
    for fid in (0, 5, 10):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([fid])[0])
    tr.run_steps(20)
    torch.set_num_threads(threads)
    return tr


def _pts(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -1.5, 1.5, (n, 3)).astype(np.float32)


def test_engine_matches_trainer_queries(trained):
    eng = SDFQueryEngine.from_trainer(trained)
    pts = _pts(300)
    np.testing.assert_allclose(eng.sdf(pts), trained.sdf_fn(pts), atol=1e-6)
    np.testing.assert_allclose(eng.grad(pts), trained.grad_fn(pts),
                               atol=1e-5)
    assert eng.device == trained.device
    assert eng.sdf(np.zeros((0, 3), np.float32)).shape == (0,)


def test_engine_multi_chunk_path(trained):
    eng_small = SDFQueryEngine.from_trainer(trained, chunk_size=64)
    eng_big = SDFQueryEngine.from_trainer(trained, chunk_size=1 << 16)
    pts = _pts(300, seed=1)  # 300 > 64: five chunks
    np.testing.assert_allclose(eng_small.sdf(pts), eng_big.sdf(pts),
                               atol=1e-6)
    np.testing.assert_allclose(eng_small.grad(pts), eng_big.grad(pts),
                               atol=1e-5)


def test_engine_costs_and_collision(trained):
    eng = SDFQueryEngine.from_trainer(trained)
    pts = _pts(100, seed=2)
    sdf = eng.sdf(pts)
    np.testing.assert_allclose(eng.chomp_cost(pts, epsilon=1.5),
                               chomp_cost(sdf, epsilon=1.5), atol=1e-6)
    np.testing.assert_allclose(eng.linear_cost(pts, epsilon=1.0),
                               linear_cost(sdf, epsilon=1.0), atol=1e-6)
    col = eng.collision(pts, margin=float(sdf.max()) + 1.0)
    assert col["collides"] and col["n_below"] == len(pts)
    col = eng.collision(pts, margin=float(sdf.min()) - 1.0)
    assert not col["collides"] and col["n_below"] == 0
    assert np.isclose(col["min_sdf"], sdf.min())
    assert col["argmin"] == int(sdf.argmin())


def test_engine_input_validation(trained):
    import isdf_tpu_torch.serve as SV
    eng = SDFQueryEngine.from_trainer(trained)
    with pytest.raises(ValueError):
        eng.sdf(np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError):
        eng.sdf(np.zeros((SV.MAX_POINTS + 1, 3), np.float32))
    bad = np.zeros((4, 3), np.float32)
    bad[2, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        eng.sdf(bad)
    bad[2, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        eng.grad(bad)


def test_from_checkpoint_no_config(trained, tmp_path):
    """The archive alone (model description and scene frame in its meta)
    reproduces the trainer's queries; a config override gives the same."""
    path = str(tmp_path / "map.npz")
    trained.save_checkpoint(path, step=20)
    eng = SDFQueryEngine.from_checkpoint(path, device="cpu")
    pts = _pts(200, seed=3)
    np.testing.assert_allclose(eng.sdf(pts), trained.sdf_fn(pts), atol=1e-6)
    np.testing.assert_allclose(eng.grad(pts), trained.grad_fn(pts),
                               atol=1e-5)
    info = eng.info()
    assert info["step"] == 20 and info["device"] == "cpu"
    assert info["param_count"] == sum(
        w.numel() + b.numel() for w, b in TM.unpack(trained.params,
                                                    trained.model))
    eng2 = SDFQueryEngine.from_checkpoint(path, config=_cfg(), device="cpu")
    np.testing.assert_allclose(eng2.sdf(pts), eng.sdf(pts), atol=1e-6)


def test_from_checkpoint_nontrivial_transform(trained, tmp_path):
    """The scene frame is part of the map: a checkpoint saved under a
    rotated domain serves with that domain's inverse transform, and
    load_checkpoint restores it into a fresh trainer."""
    from isdf_tpu_torch.engine.trainer import Trainer
    tr = trained
    saved = (tr.bounds_transform_np.copy(), tr.scene_extents_np.copy())
    a = np.deg2rad(30.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]], np.float32)
    T[:3, 3] = [0.3, -0.2, 0.1]
    try:
        tr.set_scene_properties(T, np.array([5.0, 3.0, 4.0], np.float32))
        path = str(tmp_path / "rot.npz")
        tr.save_checkpoint(path, step=21)
        eng = SDFQueryEngine.from_checkpoint(path, device="cpu")
        pts = _pts(150, seed=4)
        np.testing.assert_allclose(eng.sdf(pts), tr.sdf_fn(pts), atol=1e-6)
        tr2 = Trainer(tr.cfg, dataset=tr.dataset, seed=99, device="cpu",
                      grid_dim=8)
        assert not np.allclose(tr2.bounds_transform_np, T)
        tr2.load_checkpoint(path)
        np.testing.assert_allclose(tr2.bounds_transform_np, T)
        np.testing.assert_allclose(tr2.sdf_fn(pts), tr.sdf_fn(pts),
                                   atol=1e-6)
    finally:
        tr.set_scene_properties(*saved)


def test_from_jax_checkpoint(tmp_path):
    """An archive written by isdf_tpu serves in the port as in isdf_tpu's
    own engine."""
    from isdf_tpu.data.synthetic import SyntheticDataset as JDataset
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.serve import SDFQueryEngine as JEngine
    from isdf_tpu.utils import checkpoint as JCK
    from isdf_tpu.utils.config import Config as JConfig
    ds = JDataset(JScene(extents=(5.0, 3.0, 4.0)), n_frames=6, H=16, W=24)
    jt = JTrainer(_small(JConfig).replace(hidden_feature_size=32,
                                          kf_buffer_size=8),
                  dataset=ds, seed=2, grid_dim=8)
    a = np.deg2rad(20.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0],
                          [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    jt.set_scene_properties(T, np.array([4.0, 3.0, 5.0], np.float32))
    path = str(tmp_path / "jax.npz")
    JCK.save_checkpoint(path, jt, step=3)
    eng = SDFQueryEngine.from_checkpoint(path, device="cpu")
    want = JEngine.from_checkpoint(path)
    pts = _pts(200, seed=9)
    np.testing.assert_allclose(eng.sdf(pts), want.sdf(pts), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(eng.grad(pts), want.grad(pts), rtol=1e-5,
                               atol=1e-5)
    assert eng.info()["param_count"] == want.info()["param_count"]


def test_refresh_from_trainer(trained):
    eng = SDFQueryEngine.from_trainer(trained)
    pts = _pts(50, seed=5)
    before = eng.sdf(pts)
    saved = (TM.copy_params(trained.params),
             {k: (TM.copy_params(v) if isinstance(v, dict) else v)
              for k, v in trained.opt_state.items()},
             trained.tot_step_time, trained.steps_since_frame,
             trained.steps_taken, trained.buffer.frame_avg_loss.clone(),
             trained.buffer.loss_approx.clone())
    try:
        trained.run_steps(5)
        # the engine serves its own copy until refreshed
        np.testing.assert_allclose(eng.sdf(pts), before, atol=1e-6)
        assert not np.allclose(trained.sdf_fn(pts), before, atol=1e-6)
        eng.refresh_from_trainer(trained)
        np.testing.assert_allclose(eng.sdf(pts), trained.sdf_fn(pts),
                                   atol=1e-6)
    finally:
        (trained.params, trained.opt_state, trained.tot_step_time,
         trained.steps_since_frame, trained.steps_taken) = saved[:5]
        trained.buffer.frame_avg_loss.copy_(saved[5])
        trained.buffer.loss_approx.copy_(saved[6])


# ------------------------------------------------------------------ http
@pytest.fixture(scope="module")
def server(trained):
    srv = SDFQueryServer(SDFQueryEngine.from_trainer(trained),
                         port=0).start()
    yield srv
    srv.stop()


def _post(srv, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_healthz(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info["ok"] and info["param_count"] > 0
    assert info["device"] == "cpu"


def test_http_sdf_grad_query(server, trained):
    pts = _pts(40, seed=6)
    code, out = _post(server, "/sdf", {"points": pts.tolist()})
    assert code == 200
    np.testing.assert_allclose(out["sdf"], trained.sdf_fn(pts), atol=1e-5)
    code, out = _post(server, "/grad", {"points": pts.tolist()})
    np.testing.assert_allclose(out["grad"], trained.grad_fn(pts), atol=1e-4)
    code, out = _post(server, "/query",
                      {"points": pts.tolist(), "epsilon": 1.5})
    sdf = np.asarray(out["sdf"])
    np.testing.assert_allclose(out["chomp_cost"],
                               chomp_cost(sdf, epsilon=1.5), atol=1e-6)
    assert "grad" in out
    code, out = _post(server, "/query",
                      {"points": pts.tolist(), "grad": False})
    assert "grad" not in out


def test_http_collision_and_errors(server):
    pts = _pts(30, seed=7)
    code, out = _post(server, "/collision",
                      {"points": pts.tolist(), "margin": 100.0})
    assert code == 200 and out["collides"] and out["n_below"] == 30
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/sdf", {})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/sdf", {"points": [[0.0, 0.0]]})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/sdf", {"points": [[0.0, float("nan"), 0.0]]})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/nope", {"points": [[0.0, 0.0, 0.0]]})
    assert e.value.code == 404


# ---------------------------------------------------------------- multi-map
@pytest.fixture(scope="module")
def fleet_server(trained):
    """Two maps behind one service: the trained map and an untrained one
    of another room."""
    from isdf_tpu_torch.engine.trainer import Trainer
    eng_a = SDFQueryEngine.from_trainer(trained)
    ds = SyntheticDataset(SyntheticScene(extents=(4.0, 2.6, 6.0)),
                          n_frames=4, H=24, W=32)
    tr_b = Trainer(trained.cfg, dataset=ds, seed=9, device="cpu",
                   grid_dim=8)
    eng_b = SDFQueryEngine.from_trainer(tr_b)
    srv = SDFQueryServer({"robot_a": eng_a, "robot_b": eng_b},
                         port=0).start()
    yield srv, eng_a, eng_b
    srv.stop()


def test_http_multi_map_routes(fleet_server):
    srv, eng_a, eng_b = fleet_server
    pts = _pts(25, seed=11)
    code, out_a = _post(srv, "/scene/robot_a/sdf", {"points": pts.tolist()})
    assert code == 200
    np.testing.assert_allclose(out_a["sdf"], eng_a.sdf(pts), atol=1e-5)
    code, out_b = _post(srv, "/scene/robot_b/sdf", {"points": pts.tolist()})
    np.testing.assert_allclose(out_b["sdf"], eng_b.sdf(pts), atol=1e-5)
    assert not np.allclose(out_a["sdf"], out_b["sdf"])
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert set(info["scenes"]) == {"robot_a", "robot_b"}
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/scene/robot_b/healthz",
            timeout=30) as r:
        assert json.loads(r.read())["ok"]


def test_http_multi_map_errors(fleet_server):
    srv, _, _ = fleet_server
    pts = [[0.0, 0.0, 0.0]]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/sdf", {"points": pts})
    assert e.value.code == 404
    assert "scenes" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/scene/nope/sdf", {"points": pts})
    assert e.value.code == 404


def test_single_map_bare_routes_unchanged(trained):
    srv = SDFQueryServer({"only": SDFQueryEngine.from_trainer(trained)},
                         port=0).start()
    try:
        pts = _pts(10, seed=12)
        code, out = _post(srv, "/sdf", {"points": pts.tolist()})
        assert code == 200 and len(out["sdf"]) == 10
        code, out2 = _post(srv, "/scene/only/sdf", {"points": pts.tolist()})
        np.testing.assert_allclose(out2["sdf"], out["sdf"])
    finally:
        srv.stop()


def test_ensemble_engine(trained):
    eng_a = SDFQueryEngine.from_trainer(trained)
    eng_b = SDFQueryEngine.from_trainer(trained)
    eng_b.params = {k: v + 0.01 for k, v in eng_b.params.items()}
    ens = EnsembleEngine([eng_a, eng_b])
    pts = _pts(50, seed=13)
    np.testing.assert_allclose(
        ens.sdf(pts), 0.5 * (eng_a.sdf(pts) + eng_b.sdf(pts)), atol=1e-6)
    np.testing.assert_allclose(
        ens.grad(pts), 0.5 * (eng_a.grad(pts) + eng_b.grad(pts)), atol=1e-6)
    col = ens.collision(pts, margin=100.0)
    assert col["collides"] and col["n_below"] == 50
    info = ens.info()
    assert info["ensemble"] == 2 and len(info["members"]) == 2
    with pytest.raises(ValueError):
        EnsembleEngine([])
    srv = SDFQueryServer(ens, port=0).start()
    try:
        code, out = _post(srv, "/sdf", {"points": pts.tolist()})
        assert code == 200
        np.testing.assert_allclose(out["sdf"], ens.sdf(pts), atol=1e-5)
    finally:
        srv.stop()


def test_cli_serves_a_fleet(trained, tmp_path, monkeypatch):
    """``python -m isdf_tpu_torch.serve``'s main: NAME=PATH maps and a
    '+'-joined ensemble, served on the CPU with --device cpu."""
    import threading

    import isdf_tpu_torch.serve as SV
    path = str(tmp_path / "m.npz")
    trained.save_checkpoint(path, step=1)
    started = {}
    orig_start = SV.SDFQueryServer.start

    def start(self):
        started["srv"] = self
        return orig_start(self)

    monkeypatch.setattr(SV.SDFQueryServer, "start", start)
    # main joins the server thread: a client thread stops the server once
    # the routes have answered
    results = {}

    def client():
        import time
        while "srv" not in started:
            time.sleep(0.01)
        srv = started["srv"]
        pts = _pts(8, seed=14)
        results["a"] = _post(srv, "/scene/a/sdf", {"points": pts.tolist()})
        results["e"] = _post(srv, "/scene/e/sdf", {"points": pts.tolist()})
        srv.stop()

    th = threading.Thread(target=client)
    th.start()
    SV.main(["--checkpoint", f"a={path}", "--checkpoint",
             f"e={path}+{path}", "--port", "0", "--device", "cpu"])
    th.join(timeout=60)
    pts = _pts(8, seed=14)
    want = trained.sdf_fn(pts)
    for k in ("a", "e"):
        code, out = results[k]
        assert code == 200
        np.testing.assert_allclose(out["sdf"], want, atol=1e-5)
