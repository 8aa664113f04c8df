"""The port's spans (isdf_tpu_torch/utils/profiling.py) on the CPU: off
without a profiler, nested per thread under one, stamped on the exported
Chrome trace's clock; the spans a tiny train_loop, a query request and a
multi-scene round emit, nested as placed; the idle share that
train/profile_step.py reads over them; and the benchmark's four readers of
them (benchmark/metrics) on hand-built traces."""

import json
import os
import threading
import time
from collections import Counter

import pytest
import torch

from benchmark import common
from benchmark.trace import Trace
from isdf_tpu_torch.utils import profiling as P


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    P.clear()
    yield
    torch.set_num_threads(n)
    P.clear()


def _tree(spans):
    """Counter of (name, the enclosing span's name)."""
    by = {s.sid: s for s in spans}
    return Counter((s.name, by[s.parent].name if s.parent in by else None)
                   for s in spans)


def test_without_a_profiler_a_span_keeps_nothing(monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("a record_function range was entered")
    monkeypatch.setattr(P, "_RANGE", no_range)
    sp = P.span("a", steps=3)
    assert sp is P.span("b")           # the one shared no-op context
    with sp as s:
        s.count(bytes=1)
        with P.span("c"):
            pass
    assert P.recorded() == [] and P.dropped() == 0


def test_nested_spans_keep_parents_and_counts_per_thread(tmp_path):
    opened, done = threading.Event(), threading.Event()
    tids = {}

    def worker():
        opened.wait(10)
        with P.span("w.outer", steps=2) as w:
            with P.span("w.inner"):
                pass
            w.count(added=1)
        tids["w"] = threading.get_ident()
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    with P.device_trace(str(tmp_path)):
        with P.span("outer", bytes=7):
            with P.span("inner") as i:
                i.count(points=5)
                opened.set()
                assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    got = {s.name: s for s in P.recorded()}
    assert set(got) == {"outer", "inner", "w.outer", "w.inner"}
    assert got["inner"].parent == got["outer"].sid
    assert got["outer"].parent is None
    # the worker's span opened while the main thread's were open: its
    # parent is its own thread's, none
    assert got["w.outer"].parent is None
    assert got["w.inner"].parent == got["w.outer"].sid
    assert got["outer"].counts == {"bytes": 7}
    assert got["inner"].counts == {"points": 5}
    assert got["w.outer"].counts == {"steps": 2, "added": 1}
    assert got["w.outer"].thread == tids["w"] != got["outer"].thread
    assert got["outer"].t0 <= got["inner"].t0 <= got["inner"].t1 \
        <= got["outer"].t1
    # a window that misses a span leaves it out
    assert {s.name for s in P.recorded(got["inner"].t1 + 1e-3,
                                       got["outer"].t1)} \
        <= {"outer", "w.outer", "w.inner"}


def _stamps_against_events(tmp_path, tries=3):
    """The largest start and end gaps (us) between the recorder and the
    exported events of five spans, and their durations (ms), on the first
    of ``tries`` traces where every gap is within 100 us (a loaded CPU
    can preempt between a stamp and the profiler's own)."""
    for k in range(tries):
        P.clear()
        d = str(tmp_path / f"t{k}")
        with P.device_trace(d):
            with P.span("warm"):
                pass
            for i in range(5):
                with P.span(f"s{i}"):
                    time.sleep(0.02)
        with open(os.path.join(d, "trace.json")) as f:
            doc = json.load(f)
        ev = {e["name"]: e for e in doc["traceEvents"]
              if str(e.get("name", "")).startswith("isdf.s")}
        rec = [s for s in P.recorded() if s.name.startswith("s")]
        assert len(rec) == 5 and len(ev) == 5
        gaps = [(abs(ev["isdf." + s.name]["ts"] - s.t0),
                 abs(ev["isdf." + s.name]["ts"] + ev["isdf." + s.name]["dur"]
                     - s.t1)) for s in rec]
        worst = max(max(g) for g in gaps)
        durs = [(s.t1 - s.t0) * 1e-3 for s in rec]
        if worst <= 100.0 and all(abs(x - 20.0) <= 2.0 for x in durs):
            break
    return doc, worst, durs


def test_recorder_stamps_agree_with_the_exported_events(tmp_path):
    doc, worst, durs = _stamps_against_events(tmp_path)
    base = int(doc.get("baseTimeNanoseconds", 0))
    assert base % P.TRACE_BASE_PERIOD_NS == 0
    assert worst <= 100.0
    assert all(abs(x - 20.0) <= 2.0 for x in durs), durs


def test_trace_clock_drops_the_exporters_base():
    period = P.TRACE_BASE_PERIOD_NS
    t = 3 * period + 1_234_567_000
    assert P.trace_us(t) == pytest.approx(1_234_567.0)
    assert P.trace_us(3 * period) == 0.0


def test_the_recorder_counts_what_it_drops(tmp_path, monkeypatch):
    monkeypatch.setattr(P, "SPAN_CAP", 3)
    with P.device_trace(str(tmp_path)):
        for i in range(5):
            with P.span(f"d{i}"):
                pass
    assert [s.name for s in P.recorded()] == ["d0", "d1", "d2"]
    assert P.dropped() == 2
    P.clear()
    assert P.recorded() == [] and P.dropped() == 0


# ---------------------------------------------------------------- program
TINY = dict(n_frames=15, H=48, W=64, grid_dim=32, mesh_dim=32,
            eval_times=(0.2, 0.4), eval_samples=4000, hidden_size=32,
            n_embed_funcs=3, n_rays=30)


@pytest.fixture(scope="module")
def fixture_cfg(tmp_path_factory):
    from isdf_tpu_torch.data import fixtures as TF
    return TF.write_replicaCAD_fixture(
        str(tmp_path_factory.mktemp("replica")), **TINY)


def _trainer(cfg_path, *extra):
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(cfg_path, overrides=[
        "tpu.kf_buffer_size=8", "model.iters_per_kf=4",
        "model.iters_per_frame=2", "tpu.steps_per_bundle=4",
        "eval.do_vox_comparison=0", *extra])
    return Trainer(cfg, seed=3, device="cpu")


LOOP_TREE = {
    ("loop.ingest", None), ("trainer.get_data", "loop.ingest"),
    ("data.frame", "trainer.get_data"), ("data.file_read", "data.frame"),
    ("data.png_inflate", "data.frame"), ("data.png_unfilter", "data.frame"),
    ("data.depth_transform", "data.frame"),
    ("trainer.normals", "trainer.get_data"),
    ("trainer.add_frame", "loop.ingest"),
    ("buffer.upload", "trainer.add_frame"),
    ("loop.kf_check", None), ("trainer.kf_fetch", "loop.kf_check"),
    ("loop.pose_burst", None), ("loop.save", None), ("loop.eval", None),
    ("trainer.run_steps", None), ("step.bundle", "trainer.run_steps"),
    ("step.table", "step.bundle"), ("step.eager", "step.bundle"),
    ("trainer.fetch", "trainer.run_steps")}


def test_a_tiny_train_loop_emits_its_spans_nested(fixture_cfg, tmp_path):
    from isdf_tpu_torch.engine.loop import train_loop
    tr = _trainer(fixture_cfg, "save.save_checkpoints=1",
                  "save.save_period=0.5", "model.refine_poses=1")
    # the sim clock pinned, so that the run takes the same path every time
    tr._per_step_device_s = 1.0 / 30
    save = tmp_path / "run"
    save.mkdir()

    def hook():     # frames of a few steps each, so the checks come soon
        tr.optim_frames = min(tr.optim_frames, 4)
        return {}
    with P.device_trace(str(tmp_path / "trace")):
        res = train_loop(tr, max_steps=24, extra_opt_steps=0,
                         save_path=str(save), control_hook=hook,
                         eval_hook=lambda t: {"n": 1})
    spans = P.recorded()
    tree = _tree(spans)
    assert LOOP_TREE <= set(tree), LOOP_TREE - set(tree)
    assert set(tree) <= LOOP_TREE
    bundles = [s for s in spans if s.name == "step.bundle"]
    assert sum(s.counts["steps"] for s in bundles) == res.steps
    assert tree[("step.eager", "step.bundle")] == res.steps
    checks = [s.counts["added"] for s in spans if s.name == "loop.kf_check"]
    assert set(checks) <= {0, 1} and len(checks) == tree[
        ("loop.kf_check", None)]
    reads = [s for s in spans if s.name == "data.file_read"]
    assert all(s.counts["bytes"] > 0 for s in reads)
    # every span is in the exported trace under its name
    with open(tmp_path / "trace" / "trace.json") as f:
        names = Counter(e["name"] for e in json.load(f)["traceEvents"]
                        if str(e.get("name", "")).startswith("isdf."))
    assert names == Counter("isdf." + s.name for s in spans)


def test_a_scannet_frame_read_spans_its_jpeg_decode(tmp_path):
    from isdf_tpu_torch.data import fixtures as TF
    from isdf_tpu_torch.data.datasets import ScanNetDataset
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(TF.write_scannet_fixture(str(tmp_path / "sn"),
                                               **TINY))
    ds = ScanNetDataset(cfg.scannet_dir, cfg)
    with P.device_trace(str(tmp_path / "trace")):
        ds[2]
    tree = _tree(P.recorded())
    assert tree == Counter({("data.frame", None): 1,
                            ("data.file_read", "data.frame"): 2,
                            ("data.png_inflate", "data.frame"): 1,
                            ("data.png_unfilter", "data.frame"): 1,
                            ("data.jpeg_decode", "data.frame"): 1,
                            ("data.depth_transform", "data.frame"): 1})


def test_a_query_and_a_fleet_round_emit_their_spans(fixture_cfg, tmp_path):
    import numpy as np
    from isdf_tpu_torch.parallel.multi_scene import MultiSceneStepper
    from isdf_tpu_torch.serve import SDFQueryEngine
    tr = _trainer(fixture_cfg)
    tr.add_frame(tr.get_data([0])[0])
    stepper = MultiSceneStepper([tr])
    engine = SDFQueryEngine.from_trainer(tr)
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    with P.device_trace(str(tmp_path)):
        engine.grad(pts)
        stepper.run_steps(3)
        with pytest.raises(ValueError):
            engine.sdf(np.full((4, 3), np.nan, np.float32))
    spans = P.recorded()
    tree = _tree(spans)
    serve = {("serve.validate", "serve.request"),
             ("serve.lock", "serve.request"),
             ("serve.copy_in", "serve.request"),
             ("serve.compute", "serve.request"),
             ("serve.fetch", "serve.request")}
    assert tree[("serve.request", None)] == 2
    assert all(tree[k] == 1 for k in serve - {("serve.validate",
                                               "serve.request")})
    assert tree[("serve.validate", "serve.request")] == 2
    reqs = [s for s in spans if s.name == "serve.request"]
    assert reqs[0].counts == {"grad": 1, "points": 300}
    assert reqs[1].counts == {"grad": 0, "points": 4}
    assert tree[("fleet.round", None)] == 1
    assert tree[("step.bundle", "fleet.round")] == 1
    assert tree[("fleet.fetch", "fleet.round")] == 1
    rnd = next(s for s in spans if s.name == "fleet.round")
    assert rnd.counts == {"scenes": 1, "steps": 3}


def test_profile_step_reads_idle_inside_the_rounds():
    from isdf_tpu_torch.train import profile_step as PS
    r = P.Span("fleet.round", 0.0, 100.0, 0, None, 0, {})
    s = P.Span("fleet.round", 200.0, 300.0, 1, None, 0, {})
    ivs = [(10.0, 30.0, "a"), (20.0, 30.0, "b"), (90.0, 20.0, "c"),
           (150.0, 20.0, "d"), (250.0, 10.0, "e")]
    # busy 10-50 and 90-100 in the first round, 250-260 in the second;
    # the kernel at 150 lies between them
    assert PS.idle_within(ivs, [r, s]) == pytest.approx(1 - 60 / 200)
    assert PS.idle_within(ivs, []) is None


# ---------------------------------------------------------------- readers
def _span(name, t0, t1, sid, parent=None, **counts):
    return P.Span(name, float(t0), float(t1), sid, parent, 0, counts)


BUNDLE_SPANS = [
    _span("trainer.run_steps", 95, 410, 0),
    _span("step.bundle", 100, 200, 1, 0, steps=2),
    _span("step.table", 100, 110, 2, 1),
    _span("step.replay", 110, 150, 3, 1),
    _span("step.replay", 150, 190, 4, 1),
    _span("trainer.fetch", 200, 400, 5, 0),
    # a bundle cut by the window's end is left out
    _span("step.bundle", 950, 1100, 6, steps=10),
]
# the card: the table fill, two replays running on past the bundle's end,
# the fetch's copy; then work of a bundle outside the window
BUNDLE_OPS = [(105.0, 3.0, "fill"), (120.0, 40.0, "k1"),
              (170.0, 130.0, "k2"), (302.0, 3.0, "Memcpy DtoH"),
              (960.0, 40.0, "k3")]
# idle in [100, 305): 100-105 (table), 108-120 (replay), 160-170
# (replay), 300-302 (the fetch's, past the launches)
FLEET_SPANS = [
    _span("fleet.round", 0, 500, 0, steps=4),
    _span("step.bundle", 10, 40, 1, 0, steps=2),
    _span("step.replay", 10, 40, 2, 1),
    _span("step.bundle", 40, 70, 3, 0, steps=2),
    _span("step.replay", 40, 70, 4, 1),
    _span("fleet.fetch", 70, 500, 5, 0),
]
# the second bundle's span opens while the card still runs the first's;
# idle in [10, 245): 10-20 (a launch), 120-130, 230-240
FLEET_OPS = [(20.0, 100.0, "k1"), (130.0, 100.0, "k2"),
             (240.0, 5.0, "Memcpy DtoH")]
QUERY_SPANS = [
    _span("serve.request", 500, 700, 0, grad=0, points=8),
    _span("serve.copy_in", 510, 540, 1, 0),
    _span("serve.request", 700, 900, 2, grad=1, points=8),
    _span("serve.copy_in", 705, 715, 3, 2),
]
QUERY_OPS = [(550.0, 100.0, "k"), (720.0, 160.0, "k")]

READER_CASES = [
    ("bundle.gap_ms", BUNDLE_SPANS, BUNDLE_OPS, 29e-3 / 2),
    ("bundle.launch_gap_ms", BUNDLE_SPANS, BUNDLE_OPS, 27e-3 / 2),
    ("bundle.gap_ms", FLEET_SPANS, FLEET_OPS, 30e-3 / 4),
    ("bundle.launch_gap_ms", FLEET_SPANS, FLEET_OPS, 10e-3 / 4),
    ("query.gap_ms", QUERY_SPANS, QUERY_OPS, 140e-3 / 2),
    ("query.copy_in_ms", QUERY_SPANS, QUERY_OPS, 40e-3 / 2),
]


@pytest.mark.parametrize("name,spans,ops,want", READER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(READER_CASES)])
def test_a_reader_finds_the_known_gaps(monkeypatch, name, spans, ops, want):
    monkeypatch.setattr(P, "recorded", lambda t0=None, t1=None: [
        s for s in spans if s.t1 > t0 and s.t0 < t1])
    trace = Trace(0.0, 1000.0, ops, [])
    got = common.metric_reader(name)({}, trace)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["bundle.gap_ms", "bundle.launch_gap_ms",
                                  "query.gap_ms", "query.copy_in_ms"])
def test_a_reader_reports_nothing_without_spans(monkeypatch, name):
    read = common.metric_reader(name)
    trace = Trace(0.0, 1000.0, BUNDLE_OPS, [])
    assert read({}, None) is None
    assert read({}, trace) is None              # an empty recorder
    # a program that records no spans at all (a parent checkout)
    monkeypatch.delattr(P, "recorded")
    assert read({}, trace) is None
