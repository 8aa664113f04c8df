"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import importlib
import json
import os
import re
import shutil

from benchmark import common

ROOT = common.ROOT
BENCH = common.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns)), group
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= (METRIC_KEYS - {"bound"}) | {"layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_file_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = common.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        # every departure from the source is listed by its top-level key
        assert {k.split(".")[0] for k in cfg.get("departures", {})} \
            == set(c["reduced"])
        assert set(c["reduced"]) <= set(cfg["config"])
        assert "config" in cfg and "source" in cfg and "assumed" in cfg
    for w in BENCH["workloads"]:
        cell = common.cell_spec(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        importlib.import_module("benchmark.traffic." + w["traffic"])
        assert cell["limits"]
    for m in BENCH["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_each_cell_reports_what_its_metrics_move():
    for w in BENCH["workloads"]:
        cell = common.cell_spec(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_cell_file_dropped_into_a_copy_is_found(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    w = common.load_json(os.path.join(ROOT, "benchmark", "workloads",
                                      "synthetic_pc.steps.json"))
    w["params"]["bundle"] = 60
    with open(tmp_path / "benchmark" / "workloads"
              / "synthetic_pc.steps60.json", "w") as f:
        json.dump(w, f)
    cell = common.cell_spec("synthetic_pc.steps60",
                            here=str(tmp_path / "benchmark"))
    assert cell["params"]["bundle"] == 60
    assert cell["config_file"]["name"] == "synthetic_pc"
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]


def test_gitignore_lists_the_build_cache():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        lines = f.read().splitlines()
    assert ".bench_cache/" in lines
