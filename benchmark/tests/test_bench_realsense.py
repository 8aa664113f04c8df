"""The realsense configuration and its cell on the CPU: a rehearsal of
realsense.steps at a tiny camera (the map at its published widths, E =
381), sound and with half of each batch left out; the fan-in counts
(counts_fanin.py) against counts.py where the two agree; the two fan-in
readers on hand-built spans and traces."""

import time

import pytest
import torch

from benchmark import common, run
from benchmark import counts as CNT
from benchmark import counts_fanin as CF
from benchmark.tests.test_bench_rehearsal import WIDE, _half_batch, rehearse
from benchmark.trace import Trace

CELL = "realsense.steps"


def test_a_sound_rehearsal_of_realsense_steps_is_correct(capsys):
    rc, res = rehearse(capsys, CELL, overrides=WIDE)
    assert rc == 0 and res["correct"] is True
    names = {m["name"] for m in common.cell_spec(CELL)["end_to_end"]}
    assert set(res["metrics"]) == names == {"step_ms", "steps_per_s",
                                            "setup_s"}


def test_a_traced_rehearsal_of_realsense_steps(capsys):
    """On the CPU the step runs the plain op: no span names a kernel
    variant, so the fan-in shares read nothing."""
    rc, res = rehearse(capsys, CELL, trace=1, overrides=WIDE)
    assert rc == 0 and res["correct"] is True
    assert "train_op.roofline_fanin" not in res["metrics"]
    assert "step_mfu_fanin" not in res["metrics"]


def test_half_a_batch_comes_out_incorrect(capsys, monkeypatch):
    _half_batch(monkeypatch)
    rc, res = rehearse(capsys, CELL, overrides=WIDE)
    assert rc == 0 and res["correct"] is False


def test_the_config_runs_the_shipped_map():
    cfg = common.cell_spec(CELL)["config_file"]["config"]
    emb = cfg["model"]["embedding"]
    assert emb["n_embed_funcs"] == 8 and emb["scale_input"] == 0.04
    assert cfg["model"]["hidden_feature_size"] == 256
    assert cfg["loss"]["bounds_method"] == "ray"
    assert cfg["sample"]["depth_range"] == [0.15, 3.0]
    assert cfg["tpu"]["kf_buffer_size"] == 160


@pytest.mark.parametrize("name", ["K1-pc", "K1-ray", "K1-stream"])
def test_fanin_counts_are_the_padded_ones_at_256_lanes(name):
    """At E = 256 every product is 256 deep: the fan-in count of the
    products is counts.py's."""
    fb, _ = CF.k1_flops(name, 7, 256, 256, 27000, 1000)
    assert fb == CNT.flop_count(name, 7, 256, 27000, 1000)[0]


def test_fanin_counts_grow_with_the_embedding():
    a = CF.k1_flops("K1-ray", 7, 256, 255, 27000, 0)[0]
    b = CF.k1_flops("K1-ray", 7, 256, 381, 27000, 0)[0]
    # layer 0 and the skip layer's pe rows, each in the three chains and
    # dW, deeper by 126 rows: 2 x 5 products of 126 x 256 more a point
    assert b - a == 2 * 27000 * 2 * 5 * 126 * 256
    assert CF.k1_params(7, 256, 381) == sum(
        fi * fo + fo for fi, fo in [(381, 256)] + [(256, 256)] * 2
        + [(637, 256)] + [(256, 256)] * 2 + [(256, 1)])


def _span(name, t0, t1, sid, parent=None, **counts):
    from isdf_tpu_torch.utils import profiling as P
    return P.Span(name, t0, t1, sid, parent, 1, counts)


SHAPE = dict(train_op="K1-ray/384", points=27000, embedding=381, layers=7,
             surface=0)


@pytest.mark.parametrize("counts,want", [
    ([SHAPE, SHAPE], True),
    ([SHAPE, dict(SHAPE, train_op="K1-ray/256")], True),
    ([SHAPE, {}], False),                       # an eager bundle
    ([SHAPE, dict(SHAPE, embedding=255)], False),   # shapes disagree
])
def test_the_fanin_readers(monkeypatch, counts, want):
    from isdf_tpu_torch.utils import profiling as P
    spans = [_span("step.bundle", 100 + 30000 * i, 20000 + 30000 * i, i,
                   steps=10, **c) for i, c in enumerate(counts)]
    monkeypatch.setattr(P, "recorded", lambda t0=None, t1=None: spans)
    # 20 steps of K1 at 2.26 ms on the card, billed 2.5 ms a step
    ops = [(110.0, 40000.0, "void k_train_tile<1>(Args)"),
           (40110.0, 4800.0, "k_dw"), (44910.0, 400.0, "k_reduce")]
    trace = Trace(0.0, 60000.0, ops, [])
    counters = {"steps": 20, "billed_s": 20 * 2.5e-3}
    roof = common.metric_reader("train_op.roofline_fanin")(counters, trace)
    mfu = common.metric_reader("step_mfu_fanin")(counters, trace)
    if not want:
        assert roof is None and mfu is None
        return
    fb, ff = CF.k1_flops("K1-ray", 7, 256, 381, 27000, 0)
    t_op = 45200e-6 / 20
    assert roof == pytest.approx(100 * CNT.peak_seconds(fb, ff) / t_op)
    assert mfu == pytest.approx(100 * CNT.peak_seconds(fb, ff) / 2.5e-3)
    assert 0 < mfu < roof < 100


def test_the_fanin_readers_read_nothing_without_spans(monkeypatch):
    from isdf_tpu_torch.utils import profiling as P
    trace = Trace(0.0, 1000.0, [(10.0, 5.0, "k_dw")], [])
    for name in ("train_op.roofline_fanin", "step_mfu_fanin"):
        read = common.metric_reader(name)
        assert read({"steps": 1, "billed_s": 1.0}, None) is None
        assert read({"steps": 1, "billed_s": 1.0}, trace) is None
    monkeypatch.delattr(P, "recorded")
    for name in ("train_op.roofline_fanin", "step_mfu_fanin"):
        assert common.metric_reader(name)({"steps": 1}, trace) is None
