"""Whole runs of the cut-size cells on the CPU (the look for a card
skipped): the result line, the check, the trace, and what a run loads."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_align_cell_result_line(tiny_root, capsys):
    assert tiny.run(tiny_root, "tiny.align") == 0
    res = last_line(capsys)
    assert list(res) == KEYS + ["checks"]  # the checks' numbers come last
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "candidates_per_s", "peak_host_gib"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checks"] == {"mismatched_alignments": {"value": 0, "limit": 0}}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_assemble_cell_traced(tiny_root, capsys):
    assert tiny.run(tiny_root, "tiny.assemble", trace=1) == 0
    res = last_line(capsys)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"] is True
    assert {"stage_s.front", "stage_s.align", "stage_s.graphs"} <= set(res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())


def test_run_loads_no_jax(tiny_root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.tests import tiny\n"
        "rc = tiny.run(%r, 'tiny.align')\n"
        "from perfbench import harness\n"
        "print('FORBIDDEN', harness.forbidden_modules(), rc)\n"
    ) % (harness.ROOT, tiny_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    line = [x for x in out.stdout.splitlines() if x.startswith("FORBIDDEN")]
    assert line == ["FORBIDDEN [] 0"], out.stderr[-2000:]


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the look for a card passes on a machine with one")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "ont-r9.align",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_host_threads_from_the_configuration():
    code = ("import os, runpy, sys; sys.argv = ['run.py', '--workload', 'ont-ul.align']; "
            "runpy.run_path('perfbench/run.py'); print(os.environ['OMP_NUM_THREADS'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="7"))
    with open(os.path.join(harness.ROOT, "perfbench", "configs", "ont-ul.json")) as f:
        want = json.load(f)["host_threads"]
    assert out.stdout.split() == [str(want)], out.stderr[-2000:]
