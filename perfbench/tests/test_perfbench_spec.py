"""BENCHMARK.json against the contract, and every part of every cell
found by name."""

import json
import os
import re
import shutil

from perfbench import harness
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return harness.load_spec()


def test_keys_and_names():
    s = spec()
    assert set(s) == TOP
    assert s["command"] == ["python3", "perfbench/run.py"]
    assert s["paths"] == ["perfbench"]
    assert 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 << 10
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])


def test_every_cell_finds_its_parts_by_name():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    for w in s["workloads"]:
        cfg = harness.config_of(s, w)
        traffic = harness.traffic_of(w)
        assert cfg["name"] == w["config"] and traffic["driver"] in ("assemble", "align")
        ends = harness.metrics_of(s, w, trace=False)
        layers = harness.metrics_of(s, w, trace=True)
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2 and layers
        for m in ends + layers:
            assert callable(harness.reader(m["name"]))
        for m in layers:  # each per-layer metric moves a metric its cell reports
            assert m["moves"] in {x["name"] for x in ends} and m["moves"] in e2e


def test_configs_name_their_cut():
    s = spec()
    for c in s["configs"]:
        cfg = harness.config_of(s, {"config": c["name"]})
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path):
    root = tiny.make(str(tmp_path))
    metric = os.path.join(root, "perfbench", "metrics", "items_per_window.py")
    with open(metric, "w") as f:
        f.write("def read(run):\n    return run.items\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["per_layer"].append({"name": "items_per_window", "unit": "items", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "candidates_per_s", "workloads": ["tiny.align"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    s = harness.load_spec(root)
    w = harness.cell(s, "tiny.align")
    assert harness.config_of(s, w, root)["name"] == "tiny"
    assert harness.traffic_of(w, root)["genome_bases"] == 15000
    layers = [m["name"] for m in harness.metrics_of(s, w, trace=True)]
    assert "items_per_window" in layers
    read = harness.reader("items_per_window", root)
    assert read(type("R", (), {"items": 3})) == 3
    # The committed files are untouched: the copy differs only by additions.
    for dirpath, _dirs, files in os.walk(os.path.join(harness.ROOT, "perfbench")):
        if "tests" in dirpath or "__pycache__" in dirpath:
            continue
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), harness.ROOT)
            with open(os.path.join(harness.ROOT, rel), "rb") as a, \
                    open(os.path.join(root, rel), "rb") as b:
                assert a.read() == b.read(), rel
    shutil.rmtree(root)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "shasta_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "shasta_tpu.ops", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["shasta_tpu.ops"]
