"""The port's HTTP viewer (vis/server.py), the loop's live controls
(engine/loop.py control_hook) and the viewers' show() against isdf_tpu's
on the CPU, side by side on tests/test_server.py's analytic grid
(SyntheticScene, extents (4, 3, 4), 24^3).

Tolerances:
* meta, slices (decoded), status, controls and HTTP codes: exactly equal.
* queries: the point and grid_sdf exactly; sdf within 1e-6 for the
  analytic sdf_fn (each package's own SyntheticScene, float32); over
  paired trainers (the port's weights from isdf_tpu's by params_from_jax)
  the snapshot grids within rtol 1e-5 and a query's sdf within rtol 1e-5
  plus the 1e-5 of its 5-place rounding.
* render_png and scene_png: the renders' image bounds against isdf_tpu's
  matplotlib renders (tests/test_torch_vis_draw.py: IoU of the non-white
  masks >= IOU_MIN, mean |diff| after a 5x5 box blur <= BLUR_MAX).
* keyframes_png: exactly equal.
* The loop: a paused loop takes no step and its sim clock stands still;
  the bundle sizes under a scripted hook equal isdf_tpu's round for round.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest

from isdf_tpu.data.synthetic import SyntheticDataset as JDataset
from isdf_tpu.data.synthetic import SyntheticScene as JScene
from isdf_tpu.vis import server as JSV
from isdf_tpu_torch.data.synthetic import SyntheticScene as TScene
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.vis import server as TSV
from isdf_tpu_torch.vis import viewer as TV
from tests.test_torch_vis_draw import BLUR_MAX, IOU_MIN, agreement

EXTENTS = (4.0, 3.0, 4.0)
D = 24
TOL_SDF = 1e-6        # analytic sdf_fn, each package's own
TOL_TRAINER = 1e-5    # rtol of the MLP's SDF across the packages


def _grid():
    axes = [np.linspace(-e / 2, e / 2, D) for e in EXTENTS]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return JScene(extents=EXTENTS).sdf_np(pts.reshape(-1, 3)).reshape(
        D, D, D)


def _grid_sources():
    grid = _grid()
    return (JSV.ViewerSource.from_grid(
                grid, extents=EXTENTS, sdf_fn=JScene(extents=EXTENTS).sdf_np),
            TSV.ViewerSource.from_grid(
                grid, extents=EXTENTS, sdf_fn=TScene(extents=EXTENTS).sdf_np))


@pytest.fixture(scope="module")
def servers():
    """isdf_tpu's and the port's viewers over the analytic grid."""
    j, t = _grid_sources()
    vj, vt = JSV.SDFWebViewer(j, port=0).start(), TSV.SDFWebViewer(
        t, port=0).start()
    yield vj, vt
    vj.stop()
    vt.stop()


def _small(cls):
    return cls().replace(
        dataset_format="synthetic", n_rays=8, n_strat_samples=5,
        n_surf_samples=3, hidden_feature_size=32, hidden_layers_block=1,
        n_embed_funcs=3, kf_buffer_size=4, do_eval=False,
        mm_precision="highest")


_PAIR = {}


def _paired():
    """isdf_tpu's and the port's trainers on one dataset, the port's
    weights carried across from isdf_tpu's, frames 0 and 4 added."""
    if not _PAIR:
        from isdf_tpu.engine.trainer import Trainer as JTrainer
        from isdf_tpu.utils.config import Config as JConfig
        from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
        from isdf_tpu_torch.utils.config import Config as TConfig
        ds = JDataset(JScene(), n_frames=8, H=24, W=32)
        jt = JTrainer(_small(JConfig), dataset=ds, seed=0, grid_dim=16)
        tt = TTrainer(_small(TConfig), dataset=ds, seed=0, device="cpu",
                      grid_dim=16)
        tt.params = TM.params_from_jax(jt.params, tt.model)
        for tr in (jt, tt):
            for fid in (0, 4):
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
        _PAIR.update(jt=jt, tt=tt)
    return _PAIR["jt"], _PAIR["tt"]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _decode(png: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)


# ------------------------------------------------------- meta, slices, query

def test_meta_equal(servers):
    vj, vt = servers
    assert json.loads(_get(vt.port, "/api/meta")[1]) == json.loads(
        _get(vj.port, "/api/meta")[1])


@pytest.mark.parametrize("i", [-5, 0, 11, 23, 40])
def test_slice_png_equals_isdf_tpus(servers, i):
    vj, vt = servers
    (cj, bj), (ct, bt) = (_get(v.port, f"/api/slice/{i}.png")
                          for v in (vj, vt))
    assert cj == ct == 200
    np.testing.assert_array_equal(_decode(bt), _decode(bj))


@pytest.mark.parametrize("irc", [(12, 7, 3), (0, 0, 0), (23, 23, 23),
                                 (30, -3, 50), (5, 12, 20)])
def test_query_equals_isdf_tpus(servers, irc):
    vj, vt = servers
    path = "/api/query?i={}&r={}&c={}".format(*irc)
    qj, qt = (json.loads(_get(v.port, path)[1]) for v in (vj, vt))
    assert qt["point"] == qj["point"]
    assert qt["grid_sdf"] == qj["grid_sdf"]
    assert abs(qt["sdf"] - qj["sdf"]) <= TOL_SDF


def test_trainer_source_queries_equal_isdf_tpus():
    jt, tt = _paired()
    sj = JSV.ViewerSource.from_trainer(jt)
    st = TSV.ViewerSource.from_trainer(tt)
    np.testing.assert_allclose(st.grid_pc, sj.grid_pc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.grid, sj.grid, rtol=TOL_TRAINER,
                               atol=1e-7)
    for irc in ((8, 8, 8), (0, 3, 15), (15, 0, 2)):
        qj, qt = sj.query(*irc), st.query(*irc)
        assert qt["point"] == qj["point"]
        for k in ("sdf", "grid_sdf"):
            assert abs(qt[k] - qj[k]) <= TOL_TRAINER * abs(qj[k]) + 1e-5


# ---------------------------------------------------------------- images

@pytest.mark.parametrize("azim,elev", [(30.0, 20.0), (-120.0, 40.0)])
def test_render_png_within_image_bounds(servers, azim, elev):
    vj, vt = servers
    path = f"/api/render.png?azim={azim}&elev={elev}"
    a, b = (cv2.imdecode(np.frombuffer(_get(v.port, path)[1], np.uint8),
                         cv2.IMREAD_COLOR) for v in (vj, vt))
    assert a.shape == b.shape == (480, 480, 3)
    iou, blur = agreement(a, b)
    assert iou >= IOU_MIN and blur <= BLUR_MAX, (iou, blur)


@pytest.mark.parametrize("azim,elev,zoom", [(45.0, 25.0, 1.0),
                                            (200.0, -10.0, 2.0)])
def test_scene_png_within_image_bounds(servers, azim, elev, zoom):
    vj, vt = servers
    path = f"/api/scene.png?azim={azim}&elev={elev}&zoom={zoom}"
    a, b = (cv2.imdecode(np.frombuffer(_get(v.port, path)[1], np.uint8),
                         cv2.IMREAD_COLOR) for v in (vj, vt))
    assert a.shape == b.shape
    iou, blur = agreement(a, b)
    assert iou >= IOU_MIN and blur <= BLUR_MAX, (iou, blur)


def test_live_scene_and_keyframes_png():
    """A trainer-backed source: the keyframe strip exactly, the live
    composite (frustums, trajectory, the latest depth as points) within
    the image bounds, on one shared mesh (the two maps' grids differ in
    the last bits, and marching tets may split a vertex differently)."""
    jt, tt = _paired()
    sj = JSV.ViewerSource.from_trainer(jt, loop_attached=True)
    st = TSV.ViewerSource.from_trainer(tt, loop_attached=True)
    np.testing.assert_array_equal(_decode(st.keyframes_png()),
                                  _decode(sj.keyframes_png()))
    js, ts = _grid_sources()
    js._ensure_mesh()
    for s in (sj, st):
        s._verts, s._faces = js._verts, js._faces
    for s in (sj, st):
        s.update_controls({"scene_pc": True})
    a, b = (cv2.imdecode(np.frombuffer(s.scene_png(45.0, 25.0), np.uint8),
                         cv2.IMREAD_COLOR) for s in (sj, st))
    iou, blur = agreement(a, b)
    assert iou >= IOU_MIN and blur <= BLUR_MAX, (iou, blur)


# ------------------------------------------------------ status and controls

def test_status_equal_on_a_paused_trainer():
    jt, tt = _paired()
    sj = JSV.ViewerSource.from_trainer(jt, loop_attached=True)
    st = TSV.ViewerSource.from_trainer(tt, loop_attached=True)
    for s in (sj, st):
        s.update_controls({"paused": True})
    a, b = sj.status(), st.status()
    assert a == b and a["paused"] is True and a["keyframes"] == 2


CONTROL_INPUTS = [
    {}, {"paused": True, "iters_per_step": 25, "do_mesh": False},
    {"iters_per_step": -5}, {"iters_per_step": 20000},
    {"iters_per_step": 7.9}, {"iters_per_step": "12"}, {"paused": "no"},
    {"paused": 0, "do_slices": []}, {"scene_pc": 1, "bogus": 3},
    {"scene_mesh": None, "scene_frustums": "", "scene_traj": 2.5},
    {"iters_per_step": "abc"}, {"iters_per_step": None},
    {"iters_per_step": [1]}, {"iters_per_step": True}]


@pytest.mark.parametrize("d", CONTROL_INPUTS)
def test_update_controls_equal_isdf_tpus(d):
    out = []
    for s in _grid_sources():
        try:
            out.append(s.update_controls(dict(d)))
        except (ValueError, TypeError) as e:
            out.append(type(e).__name__)
    assert out[1] == out[0]


BIG = b'{"paused": true, "pad": "' + b"x" * 5000 + b'"}'
ROUTES = [
    ("GET", "/", None), ("GET", "/api/meta", None),
    ("GET", "/api/status", None), ("GET", "/api/refresh", None),
    ("GET", "/api/control", None), ("GET", "/api/query?i=3&r=2&c=1", None),
    ("GET", "/api/query?i=x", None), ("GET", "/api/slice/3.png", None),
    ("GET", "/api/slice/abc.png", None), ("GET", "/api/slice/3.jpg", None),
    ("GET", "/api/render.png?azim=abc", None),
    ("GET", "/api/scene.png?zoom=x", None),
    ("GET", "/api/keyframes.png", None), ("GET", "/api/nope", None),
    ("GET", "/nope", None),
    ("POST", "/api/control", b'{"iters_per_step": 3}'),
    ("POST", "/api/control", b"not json"), ("POST", "/api/control", b"[1]"),
    ("POST", "/api/control", b'{"iters_per_step": "abc"}'),
    ("POST", "/api/control", b'{"iters_per_step": null}'),
    ("POST", "/api/control", b'{"iters_per_step": 1e999}'),
    ("POST", "/api/control", BIG), ("POST", "/api/control", b""),
    ("POST", "/api/refresh", b"{}"), ("POST", "/api/nope", b"{}")]


@pytest.mark.parametrize("method,path,body", ROUTES)
def test_http_codes_equal_isdf_tpus(servers, method, path, body):
    codes = [(_get(v.port, path) if method == "GET"
              else _post(v.port, path, body))[0] for v in servers]
    assert codes[1] == codes[0]
    for v in servers:   # leave the controls as they were
        v.source.update_controls({"paused": False, "iters_per_step": 0})


def test_http_codes_cover_404_413_400_500(servers):
    vt = servers[1]
    assert _get(vt.port, "/api/nope")[0] == 404
    assert _post(vt.port, "/api/control", BIG)[0] == 413
    assert _post(vt.port, "/api/control", b"not json")[0] == 400
    assert _get(vt.port, "/api/query?i=x")[0] == 500


# ---------------------------------------------------------------- the loop

def _tiny_trainer(pkg):
    if pkg == "isdf_tpu":
        from isdf_tpu.engine.trainer import Trainer
        from isdf_tpu.utils.config import Config
        return Trainer(_small(Config).replace(steps_per_bundle=8),
                       dataset=JDataset(JScene(), n_frames=4, H=24, W=32),
                       seed=0, grid_dim=16)
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import Config
    return Trainer(_small(Config).replace(steps_per_bundle=8),
                   dataset=JDataset(JScene(), n_frames=4, H=24, W=32),
                   seed=0, device="cpu", grid_dim=16)


def test_controls_honored_by_live_loop():
    """Paused over HTTP, the loop takes no step and its sim clock stands
    still; resumed, it finishes; iters_per_step 3 caps every bundle."""
    from isdf_tpu_torch.engine.loop import train_loop
    tr = _tiny_trainer("isdf_tpu_torch")
    src = TSV.ViewerSource.from_trainer(tr, loop_attached=True)
    v = TSV.SDFWebViewer(src, port=0).start()
    try:
        def control_hook():
            c = src.get_controls()
            if c.get("paused"):
                src.refresh_if_watched()
            return c

        _post(v.port, "/api/control",
              json.dumps({"paused": True, "iters_per_step": 3}).encode())
        out = {}
        th = threading.Thread(target=lambda: out.update(res=train_loop(
            tr, max_steps=12, control_hook=control_hook)), daemon=True)
        th.start()
        time.sleep(1.0)
        assert tr.steps_taken == 0 and tr.tot_step_time == 0.0
        status = json.loads(_get(v.port, "/api/status")[1])
        assert status["paused"] is True and status["steps"] == 0
        _post(v.port, "/api/control", b'{"paused": false}')
        th.join(timeout=300)
        assert not th.is_alive()
        res = out["res"]
        assert res.steps == 12 and res.rounds >= 4
    finally:
        v.stop()


def test_scripted_caps_bundle_like_isdf_tpu():
    """A hook capping bundles at 3, then 0 (the config's 8), then 5, in
    turn: within the first frame's 200 steps the schedule does not depend
    on the map, and the bundle sizes equal isdf_tpu's round for round."""
    from isdf_tpu.engine.loop import train_loop as j_loop
    from isdf_tpu_torch.engine.loop import train_loop as t_loop
    sizes = {}
    for pkg, loop in (("isdf_tpu", j_loop), ("isdf_tpu_torch", t_loop)):
        tr = _tiny_trainer(pkg)
        seen, calls = [], []
        run = tr.run_steps

        def spy(n, run=run, seen=seen):
            seen.append(n)
            return run(n)

        tr.run_steps = spy

        def hook(calls=calls):
            calls.append(None)
            return {"iters_per_step": (3, 0, 5)[(len(calls) - 1) % 3]}

        res = loop(tr, max_steps=40, control_hook=hook)
        assert res.steps == 40 == sum(seen)
        sizes[pkg] = seen
    assert sizes["isdf_tpu_torch"] == sizes["isdf_tpu"]
    assert sizes["isdf_tpu"][:3] == [3, 8, 5]


# ---------------------------------------------------------------- show()

@pytest.mark.parametrize("i", [0, 7, 23])
def test_slice_viewer_show_serves_its_slices(i):
    grid = _grid()
    sv = TV.SDFSliceViewer(grid, up_ix=1, sdf_range=(-1.5, 2.5))
    web = sv.show(port=0, block=False)
    try:
        code, body = _get(web.port, f"/api/slice/{i}.png")
        assert code == 200
        want = np.repeat(np.repeat(sv._slice_img(i), 3, 0), 3, 1)
        np.testing.assert_array_equal(_decode(body)[..., ::-1], want)
        meta = json.loads(_get(web.port, "/api/meta")[1])
        assert meta["n_slices"] == D and meta["up_ix"] == 1
        assert meta["sdf_range"] == [-1.5, 2.5]
    finally:
        web.stop()


def test_pointcloud_viewer_show_serves_its_slabs():
    rng = np.random.default_rng(4)
    pc = np.concatenate([rng.uniform(-1, 1, (3000, 3)),
                         rng.normal(size=(3000, 1)) * 0.5], 1)
    pv = TV.SDFPointcloudViewer(pc.astype(np.float32), max_slabs=12)
    web = pv.show(port=0, block=False)
    try:
        meta = json.loads(_get(web.port, "/api/meta")[1])
        assert meta["n_slices"] == len(pv.zs) == 12
        for i in (0, 5, 11):
            code, body = _get(web.port, f"/api/slice/{i}.png")
            assert code == 200
            np.testing.assert_array_equal(_decode(body)[..., ::-1],
                                          pv._slab_img(i))
            q = json.loads(_get(web.port, f"/api/query?i={i}&r=0&c=0")[1])
            assert q == {"slab": i, "z": round(float(pv.zs[i]), 4)}
        assert _get(web.port, "/api/render.png")[0] == 200
    finally:
        web.stop()


def test_server_cli_serves_a_grid(tmp_path, monkeypatch):
    """python -m isdf_tpu_torch.vis.server --grid G.npy: serves until
    interrupted (the serving loop is stubbed to read one slice)."""
    path = str(tmp_path / "g.npy")
    np.save(path, _grid())
    got = {}

    def serve(self):
        httpd = self.httpd
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        got["meta"] = json.loads(_get(self.port, "/api/meta")[1])
        got["slice"] = _get(self.port, "/api/slice/4.png")[0]
        httpd.shutdown()
        httpd.server_close()

    monkeypatch.setattr(TSV.SDFWebViewer, "serve_until_interrupted", serve)
    TSV.main(["--grid", path, "--port", "0", "--extents", *map(
        str, EXTENTS), "--up", "2"])
    assert got["meta"]["up_ix"] == 2 and got["meta"]["shape"] == [D] * 3
    assert got["slice"] == 200


def test_no_device_work_while_loop_attached(monkeypatch):
    """Loop-attached, a handler thread never evaluates the map: queries
    read the snapshot grid and a refresh only marks itself pending."""
    _, tt = _paired()
    src = TSV.ViewerSource.from_trainer(tt, loop_attached=True)

    def boom(*a, **k):
        raise AssertionError("device work on a handler thread")

    monkeypatch.setattr(tt, "sdf_fn", boom)
    monkeypatch.setattr(tt, "get_sdf_grid", boom)
    src.sdf_fn = boom
    v = TSV.SDFWebViewer(src, port=0).start()
    try:
        for path in ("/api/query?i=8&r=8&c=8", "/api/status",
                     "/api/keyframes.png", "/api/slice/3.png",
                     "/api/scene.png?azim=10", "/api/render.png"):
            assert _get(v.port, path)[0] == 200, path
        r = json.loads(_get(v.port, "/api/refresh")[1])
        assert r["pending"] is True and r["refreshed"] is False
    finally:
        v.stop()
    monkeypatch.undo()
    version = src.version
    assert src.refresh_if_watched() == {"refreshed": True,
                                        "version": version + 1}


# ------------------------------------------------ device work beside captures

def _free_elsewhere(lock) -> bool:
    """Whether another thread can take ``lock`` now."""
    got = []

    def probe():
        ok = lock.acquire(timeout=0.05)
        got.append(ok)
        if ok:
            lock.release()

    th = threading.Thread(target=probe)
    th.start()
    th.join(timeout=30)
    return got == [True]


def test_capture_holds_the_capture_lock(monkeypatch):
    """GraphRunner.capture holds utils/graphs.CAPTURE_LOCK from
    capture_begin to capture_end (CUDA's calls stood in for on the CPU)."""
    import contextlib

    import torch

    from isdf_tpu_torch.utils import graphs as G

    class Stream:
        def wait_stream(self, other):
            pass

    events = []

    class Graph:
        def register_generator_state(self, gen):
            pass

        def capture_begin(self, pool=None):
            events.append(("begin", _free_elsewhere(G.CAPTURE_LOCK)))

        def capture_end(self):
            events.append(("end", _free_elsewhere(G.CAPTURE_LOCK)))

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    runner = G.GraphRunner("cpu")
    runner.capture(lambda: events.append(
        ("fn", _free_elsewhere(G.CAPTURE_LOCK))))
    assert events == [("begin", False), ("fn", False), ("end", False)]
    assert _free_elsewhere(G.CAPTURE_LOCK)
    (tb, te), = runner.stats["intervals"]
    assert tb <= te


def test_bundle_leaves_the_capture_lock_free():
    """Trainer.run_steps does not hold CAPTURE_LOCK over a bundle: a
    query waits for a capture only, never for the loop's steps."""
    from isdf_tpu_torch.utils.graphs import CAPTURE_LOCK
    tr = _tiny_trainer("isdf_tpu_torch")
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    bundle, inside = tr.fns.train_bundle, []

    def spy(*a, **kw):
        inside.append(_free_elsewhere(CAPTURE_LOCK))
        return bundle(*a, **kw)

    tr.fns.train_bundle = spy
    tr.run_steps(2)
    assert inside == [True]


@pytest.mark.parametrize("which", ["query", "viewer"])
def test_off_loop_device_work_waits_out_a_capture(which):
    """While a capture holds CAPTURE_LOCK, the query service's and a
    trainer viewer's (no loop attached) point queries are not evaluated;
    they are answered after."""
    from isdf_tpu_torch.serve import SDFQueryEngine, SDFQueryServer
    from isdf_tpu_torch.utils.graphs import CAPTURE_LOCK
    _, tt = _paired()
    if which == "query":
        srv = SDFQueryServer(SDFQueryEngine.from_trainer(tt), port=0)
        ask = (lambda: _post(srv.port, "/sdf", json.dumps(
            {"points": [[0.1, 0.2, 0.3]]}).encode()))
    else:
        srv = TSV.SDFWebViewer(TSV.ViewerSource.from_trainer(tt), port=0)
        ask = (lambda: _get(srv.port, "/api/query?i=3&r=4&c=5"))
    srv.start()
    try:
        done = []
        with CAPTURE_LOCK:
            th = threading.Thread(target=lambda: done.append(ask()))
            th.start()
            th.join(timeout=0.5)
            assert th.is_alive() and not done
        th.join(timeout=60)
        assert not th.is_alive() and done[0][0] == 200
    finally:
        srv.stop()


def test_loop_attached_viewer_answers_during_a_capture():
    """Loop-attached, the viewer's handlers touch no device, so every
    route answers while a capture holds CAPTURE_LOCK."""
    from isdf_tpu_torch.utils.graphs import CAPTURE_LOCK
    tr = _tiny_trainer("isdf_tpu_torch")
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    src = TSV.ViewerSource.from_trainer(tr, loop_attached=True)
    v = TSV.SDFWebViewer(src, port=0).start()
    paths = ("/api/meta", "/api/status", "/api/control",
             "/api/query?i=3&r=4&c=5", "/api/slice/3.png",
             "/api/render.png", "/api/scene.png?azim=10",
             "/api/keyframes.png", "/api/refresh")
    try:
        done = []
        with CAPTURE_LOCK:
            th = threading.Thread(target=lambda: done.extend(
                _get(v.port, p)[0] for p in paths))
            th.start()
            th.join(timeout=120)
            assert not th.is_alive() and done == [200] * len(paths)
    finally:
        v.stop()


def test_controls_and_refresh_do_not_wait_for_a_draw(monkeypatch):
    """While a render draws on a handler's thread, the loop's reads of the
    controls and its refresh return at once (a draw holds the source's
    draw lock, not the lock they take); the refresh's new snapshot then
    gets a mesh of its own."""
    tr = _tiny_trainer("isdf_tpu_torch")
    src = TSV.ViewerSource.from_trainer(tr, loop_attached=True)
    inside, release, png = threading.Event(), threading.Event(), TSV._png

    def slow_png(img):
        inside.set()
        assert release.wait(timeout=60)
        return png(img)

    monkeypatch.setattr(TSV, "_png", slow_png)
    drawer = threading.Thread(target=lambda: src.render_png(30.0, 20.0))
    drawer.start()
    try:
        assert inside.wait(timeout=60)
        version, done = src.version, []
        th = threading.Thread(target=lambda: done.extend(
            [src.get_controls(), src.refresh()]))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive() and done[1] == {"refreshed": True,
                                                 "version": version + 1}
    finally:
        release.set()
        drawer.join(timeout=60)
    assert not drawer.is_alive() and src._faces is None
    monkeypatch.undo()
    assert src._ensure_mesh()[0] == version + 1 and src._faces is not None


def test_query_json_is_coded_in_a_worker_process():
    """The query service parses a POST body and serialises an answer in a
    worker process, with the json module's own bytes."""
    import os

    from isdf_tpu_torch import serve as TS
    pool = TS._codec()
    assert pool.submit(os.getpid).result() != os.getpid()
    req, pts = pool.submit(TS._decode, json.dumps(
        {"points": [[0.1, 0.2, 0.3]], "margin": 0.5}).encode()).result()
    assert req == {"margin": 0.5} and pts.dtype == np.float32
    np.testing.assert_array_equal(pts, np.float32([[0.1, 0.2, 0.3]]))
    out = {"sdf": np.float32([0.25, -1.5])}
    assert pool.submit(TS._encode, out).result() == json.dumps(
        {"sdf": out["sdf"].tolist()}).encode()
    with pytest.raises(json.JSONDecodeError):
        pool.submit(TS._decode, b"{not json").result()
