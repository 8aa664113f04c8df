"""The yardstick's arithmetic: the frozen operation and byte counts, and
the trace reduction on a hand-made trace."""

import json

import pytest

from benchmark import counts as CNT
from benchmark import trace as TRC


@pytest.mark.parametrize("name", ["K1-pc", "K1-ray", "K1-stream", "K2",
                                  "K3", "K4"])
def test_counts_reproduce_chip_smoke(name):
    import chip_smoke
    from isdf_tpu_torch.models.sdf_mlp import SDFModel
    model = SDFModel()
    N, R = 27000, 1000
    assert CNT.flop_count(name, model.n_layers, model.hidden_size, N, R) \
        == chip_smoke.flop_count(name, model, N, R)
    assert CNT.byte_count(name, model.n_layers, model.embedding_size, N, R) \
        == chip_smoke.byte_count(name, model, N, R)


def test_k1_pc_bound_is_the_kernel_tables():
    fb, ff = CNT.flop_count("K1-pc", 7, 256, 27000, 1000)
    assert abs((fb + ff) / 1e9 - 159.5) < 0.1    # PERF.md's kernel table
    assert abs(1e3 * CNT.peak_seconds(fb, ff) - 0.1652) < 2e-3


def _write(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_share_on_a_hand_made_trace(tmp_path):
    ev = [_x("bench.window", 100, 100, "user_annotation"),
          _x("bench.run_steps", 110, 40, "user_annotation"),
          _x("bench.read_frame", 160, 30, "user_annotation"),
          _x("void k_train_tile<0>(Args)", 90, 30, "kernel"),   # 10 outside
          _x("k_dw", 115, 15, "kernel"),                         # overlaps
          _x("at::native::block_reduce_kernel", 140, 5, "kernel"),
          _x("Memcpy DtoH", 150, 2, "gpu_memcpy"),
          _x("k_reduce", 195, 10, "kernel"),                      # 5 outside
          _x("cpu_op", 120, 50, "cpu_op")]
    t = TRC.parse(_write(tmp_path, ev))
    assert t.window_s == pytest.approx(100e-6)
    # busy: [100, 130) + [140, 145) + [150, 152) + [195, 200) = 42 us
    assert t.busy_s() == pytest.approx(42e-6)
    assert t.idle_share() == pytest.approx(0.58)
    # whole-word names: block_reduce is not k_reduce
    assert t.op_seconds("k_train_tile|k_dw|k_reduce") == pytest.approx(
        (20 + 15 + 5) * 1e-6)
    busy, total = t.busy_within("bench.run_steps")
    # in [110, 150): [110, 130) and [140, 145)
    assert (busy, total) == (pytest.approx(25e-6), pytest.approx(40e-6))
    assert [n for _, _, n in t.ops_within("bench.run_steps")] == [
        "k_dw", "at::native::block_reduce_kernel"]
    gaps = dict(t.idle_gaps())
    # gaps: [130, 140) and [145, 150) in run_steps; [152, 195) has its
    # middle in read_frame
    assert gaps["bench.run_steps"] == pytest.approx(15e-6)
    assert gaps["bench.read_frame"] == pytest.approx(43e-6)


def test_a_trace_without_its_window_reads_nothing(tmp_path):
    assert TRC.parse(_write(tmp_path, [_x("k_dw", 0, 1, "kernel")])) is None
