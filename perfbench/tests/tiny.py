"""A cut-size copy of the benchmark for the CPU tests: the committed
files, plus the configuration ``tiny`` (a 15 kb genome, reads of about
2.5 kb, k 10) and its cells ``tiny.align`` and ``tiny.assemble``, added
as new files and entries the way a later change adds a cell."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

CONF = """[Reads]
minReadLength = 500
[Kmers]
k = 10
probability = 0.1
[MinHash]
minHashIterationCount = 6
maxBucketSize = 60
minFrequency = 2
[Align]
alignMethod = 3
downsamplingFactor = 0.1
matchScore = 6
minAlignedMarkerCount = 20
maxSkip = 60
maxDrift = 60
maxTrim = 60
[ReadGraph]
maxAlignmentCount = 8
[MarkerGraph]
minCoverage = 3
"""


# The tiny assemblies' own limits (a 15 kb genome at 10x reads far worse
# than the cells' 2 Mb at 25x).
TINY_ASSEMBLY_LIMITS = {"contig_errors_per_100kb": 400.0, "genome_missing_pct": 30.0}


def make(root: str) -> str:
    """Copy BENCHMARK.json and perfbench/ into ``root`` and add the tiny
    configuration, its traffic mixes and cells; returns ``root``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(BENCH, "configs", "ont-r9.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", conf=CONF)
    cfg["reads"].update(coverage=10.0, median_length=2500, sigma=0.3, min_length=1000)
    cfg["reference"].update(min_read_length=500, k=10, downsampling_factor=0.1,
                            min_aligned_marker_count=20, max_skip=60, max_drift=60, max_trim=60)
    with open(os.path.join(root, "perfbench", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for driver in ("align", "assemble"):
        traffic = {"driver": driver, "genome_bases": 15000, "check": {"random": 24, "longest": 4}}
        if driver == "assemble":
            traffic["check"]["assembly"] = dict(TINY_ASSEMBLY_LIMITS)
        with open(os.path.join(root, "perfbench", "traffic", f"tiny-{driver}.json"), "w") as f:
            json.dump(traffic, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "cut-size test configuration",
                            "file": "perfbench/configs/tiny.json", "reduced": [], "why": "tests"})
    for driver in ("align", "assemble"):
        spec["workloads"].append({"name": f"tiny.{driver}", "config": "tiny",
                                  "traffic": f"tiny-{driver}", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws:
            ws.append("tiny.assemble" if any(w.endswith(".assemble") for w in ws) else "tiny.align")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


def run(root: str, workload: str, seed: int = 2**31 + 11, trace: int = 0,
        device: str = "cpu", seconds: float = 0.5) -> int:
    """One run of a cell of the copy at ``root``, on ``device``, without
    the look for a card."""
    from perfbench import harness

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    return harness.run(args, time.monotonic(), root=root, device=device, check_device=False)
