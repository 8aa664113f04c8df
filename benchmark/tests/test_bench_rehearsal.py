"""CPU rehearsals of every traffic kind at a tiny size (a 48 x 64 camera,
8 rows, 20 rays a frame, a map 64 wide): each run through the harness
with the program's plain versions in place of its kernels. The sound
training rehearsals keep the map's published width, which the limits
were set for (at 64 wide the median leaf's change reads past them).
A sound run comes out correct; a run with the timed path broken
underneath, and the control (the reference one precision below in the
program's place), come out not correct. The cards' own runs are the
``cuda`` test at the end."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import common, run
from benchmark import trainers as TR

SMALL = {"params": {"H": 48, "W": 64, "scenes": 2, "points": 4096,
                    "distinct": 4, "check_every": 3, "trace_seconds": 0.3,
                    "lead_s": 60, "warm_s": 0},
         "config": {"tpu.kf_buffer_size": 8, "sample.n_rays": 20,
                    "model.hidden_feature_size": 64,
                    "dataset.camera.w": 64, "dataset.camera.h": 48,
                    "dataset.camera.fx": 32.0, "dataset.camera.fy": 32.0,
                    "dataset.camera.cx": 31.5, "dataset.camera.cy": 23.5,
                    "model.iters_per_kf": 6, "model.iters_per_frame": 3}}
WIDE = {"params": SMALL["params"],
        "config": {k: v for k, v in SMALL["config"].items()
                   if k != "model.hidden_feature_size"}}
# the stream's loop bills the CPU's step time on its sim clock: at the
# published width its opening bundle alone spends some 120 s of the
# sequence, which must outlast it
WIDE_STREAM = {"params": {**SMALL["params"], "lead_s": 300},
               "config": WIDE["config"]}
CELLS = ["synthetic_pc.steps", "replicacad.stream", "replicacad.query",
         "synthetic_pc.fleet4"]
TRAINING = ["synthetic_pc.steps", "replicacad.stream", "synthetic_pc.fleet4"]


def rehearse(capsys, cell, trace=0, seconds=0.5, seed=3000000019,
             overrides=SMALL):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)],
                  device=torch.device("cpu"), overrides=overrides,
                  t_process=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_rehearsal_is_correct(capsys, cell):
    wide = WIDE_STREAM if cell == "replicacad.stream" else WIDE
    rc, res = rehearse(capsys, cell,
                       overrides=wide if cell in TRAINING else SMALL)
    assert rc == 0 and res["correct"] is True
    assert list(res)[-1] == "compared"
    names = {m["name"] for m in common.cell_spec(cell)["end_to_end"]}
    assert set(res["metrics"]) == names


@pytest.mark.parametrize("cell", ["synthetic_pc.steps", "replicacad.query"])
def test_a_traced_rehearsal_reports_its_window(capsys, cell):
    rc, res = rehearse(capsys, cell, trace=1, overrides=WIDE)
    assert rc == 0 and res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(monkeypatch):
    from isdf_tpu_torch.engine.step import StepFunctions
    monkeypatch.setattr(StepFunctions, "update", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from isdf_tpu_torch.engine.step import StepFunctions
    orig = StepFunctions.loss_and_grad

    def half(self, params, transform, pc, z_vals, dirs_C, dirs_W, depth,
             normals, valid, noise, surf=None, sv=None):
        keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
        return orig(self, params, transform, pc, z_vals, dirs_C, dirs_W,
                    depth, normals, valid & keep, noise, surf=surf, sv=sv)
    monkeypatch.setattr(StepFunctions, "loss_and_grad", half)


def _altered(monkeypatch):
    from isdf_tpu_torch.serve import SDFQueryEngine
    orig = SDFQueryEngine._chunked

    def altered(self, pts, grad):
        out = orig(self, pts, grad)
        out.reshape(-1)[0] += 1e-3 * float(abs(out).max())
        return out
    monkeypatch.setattr(SDFQueryEngine, "_chunked", altered)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in TRAINING for f in (_unchanged, _half_batch)]
    + [("replicacad.query", _altered)],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_comes_out_incorrect(capsys, monkeypatch, cell,
                                                 fault):
    fault(monkeypatch)
    rc, res = rehearse(capsys, cell)
    assert rc == 0 and res["correct"] is False


def test_the_training_control_comes_out_incorrect():
    """The reference at float8 operands in the program's place."""
    cell = common.cell_spec("synthetic_pc.steps")
    ctx = common.Ctx(seed=11, seconds=0, trace=False, cell=cell,
                     device=torch.device("cpu"), t_process=0, scratch="",
                     overrides=SMALL)
    cfg = ctx.config()
    scene = TR.build(ctx, ctx.seed, cfg)
    got = TR.compare(ctx, scene, cfg,
                     TR.ref_first_steps(ctx, scene, cfg, "fp8"))
    assert not common.correct_of([[k, got[k], ctx.limit(k)]
                                  for k in cell["limits"]])


def test_the_query_control_comes_out_incorrect():
    """The reference at TF32 operands in the program's place."""
    from benchmark import calibrate
    rows = calibrate.main(["--workload", "replicacad.query", "--seeds", "12",
                           "--controls", "1"], device=torch.device("cpu"),
                          overrides=SMALL)
    cell = common.cell_spec("replicacad.query")
    ctl = rows[0]["control_tf32"]
    assert not common.correct_of([[k, ctl[k], cell["limits"][k]]
                                  for k in cell["limits"]])


def test_no_jax_after_a_rehearsal_of_every_traffic_kind(tmp_path):
    code = (
        "import json, sys, time, torch\n"
        "from benchmark import common, run\n"
        f"ov = json.loads({json.dumps(json.dumps(SMALL))})\n"
        f"for c in {CELLS!r}:\n"
        "    assert run.main(['--workload', c, '--seed', '5', '--seconds',"
        " '0.2', '--trace', '0'], device=torch.device('cpu'), overrides=ov,"
        " t_process=time.perf_counter()) == 0\n"
        "print('FORBIDDEN', common.loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "synthetic_pc.steps", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=common.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout and "no result" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells measure the port's kernels")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", "2024", "--seconds", "3", "--trace",
                        "0"], cwd=common.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
