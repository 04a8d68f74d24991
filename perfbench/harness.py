"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: ``BENCHMARK.json`` gives
the cell's configuration file and traffic name; the traffic mix is
``perfbench/traffic/<traffic>.json`` (its ``driver`` names the loop the
window runs, ``drivers.py``); each metric is read by
``perfbench/metrics/<metric>.py``'s ``read(run)``.

The last line of standard output is the result, one JSON object; the
checks' numbers, each beside its limit, are the last lines of standard
error. The program's own output goes to standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "shasta_tpu")


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Finding a cell's parts by name
# ---------------------------------------------------------------------------


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"perfbench: no workload named {name!r} in BENCHMARK.json")


def config_of(spec: dict, w: dict, root: str = ROOT) -> dict:
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, c["file"])) as f:
        return json.load(f)


def traffic_of(w: dict, root: str = ROOT) -> dict:
    with open(os.path.join(root, "perfbench", "traffic", f"{w['traffic']}.json")) as f:
        return json.load(f)


def metrics_of(spec: dict, w: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those with no ``workloads`` key and those that list it."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if w["name"] in m.get("workloads", [w["name"]])]


def reader(name: str, root: str = ROOT):
    """``read(run)`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# Host memory and disk
# ---------------------------------------------------------------------------


class PeakSampler:
    """The process's peak resident memory from now until ``stop()``,
    sampled from /proc/self/statm every ``period`` seconds on a thread.
    (The kernel's high-water mark cannot be reset on every host:
    writing /proc/self/clear_refs is refused on the card's machine.)"""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, self._rss())

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return max(self.peak, self._rss())


def bytes_written() -> Optional[int]:
    """Bytes this process has passed to write calls (``wchar`` of
    /proc/self/io: files, and its own output), or None."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent seeds derived from the run's ``--seed``."""
    return [int(x) for x in np.random.SeedSequence(int(seed)).generate_state(n)]


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_check(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards; torch.cuda.device_count() is {torch.cuda.device_count()}"
    return None


def cache_env(root: str = ROOT) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(root, ".perfbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))


def run(args, t_process: float, root: str = ROOT, device: str = "cuda",
        check_device: bool = True) -> int:
    from perfbench import drivers

    spec = load_spec(root)
    w = cell(spec, args.workload)
    if check_device:
        why = device_check(w["chips"])
        if why:
            log(f"no result: {why}")
            return 3
    cache_env(root)
    cfg = config_of(spec, w, root)
    traffic = traffic_of(w, root)
    wanted = metrics_of(spec, w, bool(args.trace))
    readers = {m["name"]: reader(m["name"], root) for m in wanted}
    driver = drivers.DRIVERS[traffic["driver"]]
    work = tempfile.mkdtemp(prefix="perfbench-")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            r = driver(cfg, traffic, args, work, device, t_process)
        runinfo = SimpleNamespace(cell=w, config=cfg, traffic=traffic, **r.record)
        values: Dict[str, float] = {}
        for m in wanted:
            v = readers[m["name"]](runinfo)
            if v is not None:
                values[m["name"]] = float(v)
        checks = r.check()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run loaded {', '.join(bad)}")
        return 4
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {
        "correct": correct,
        "attempted": int(r.record["items"]),
        "failed": 0,
        "metrics": {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in wanted if m["name"] in values
        },
        "device": r.device,
    }
    if r.breakdown is not None:
        out["breakdown"] = r.breakdown
    out["checks"] = checks
    wrote = bytes_written()
    if wrote is not None:
        log(f"disk: this process passed {wrote} bytes to write calls")
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None, t_process: Optional[float] = None) -> int:
    args = parse(argv)
    return run(args, t_process if t_process is not None else time.monotonic())
