"""Stage tracing: timestamped begin/end lines, like the reference's
performance.log (reference: src/performanceLog.hpp:10-14, stage lines
e.g. src/AssemblerMarkerGraph.cpp:75), and the program's spans."""

from __future__ import annotations

import contextlib
import datetime
import sys
import time
from typing import Dict, List, Optional, TextIO

import torch


def span(name: str):
    """A named range of the program's host time: under a running
    ``torch.profiler`` it lands in the same trace, on the same clock, as
    the device's kernels and copies; with none running it records
    nothing and skips ``record_function``'s op dispatch.
    Around an asynchronous launch it times the enqueue, not the
    device's work. Names start with ``stage:``: where the profiler's
    events carry no activity type (torch 2.11), ``perfbench/trace.py``
    tells a program span from device work by that prefix alone."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def rss_mb() -> float:
    """Current resident set size in MiB (Linux /proc)."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def peak_rss_mb() -> float:
    """High-water-mark RSS in MiB since start or the last reset."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmHWM:"):
                    return int(ln.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def reset_peak_rss() -> bool:
    """Reset VmHWM (Linux >= 5.9, needs CAP_SYS_RESOURCE or root) so
    per-stage true peaks are measurable. Returns False if unsupported."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


_malloc_trim_fn = None


def malloc_trim() -> None:
    """Return freed glibc arena pages to the OS (the reference's mmap
    allocator releases regions on remove() the same way)."""
    global _malloc_trim_fn
    if _malloc_trim_fn is None:
        try:
            import ctypes

            _malloc_trim_fn = ctypes.CDLL("libc.so.6").malloc_trim
        except OSError:
            _malloc_trim_fn = False
    if _malloc_trim_fn:
        _malloc_trim_fn(0)


def obj_nbytes(o, _seen=None) -> int:
    """Total numpy-array bytes reachable from an object's attributes
    (one level of dataclass/object nesting, dicts, lists)."""
    import numpy as np

    if _seen is None:
        _seen = set()
    if id(o) in _seen or o is None:
        return 0
    _seen.add(id(o))
    if isinstance(o, np.ndarray):
        return o.nbytes
    if isinstance(o, dict):
        return sum(obj_nbytes(v, _seen) for v in o.values())
    if isinstance(o, (list, tuple)):
        return sum(obj_nbytes(v, _seen) for v in o)
    d = getattr(o, "__dict__", None)
    if d:
        return sum(obj_nbytes(v, _seen) for v in d.values())
    return 0


class PerformanceLog:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        import os

        self._f: Optional[TextIO] = open(path, "w") if path else None
        self._echo = echo
        self.stage_seconds: Dict[str, float] = {}
        # SHASTA_TORCH_MEMPROF=1: log RSS (and, via the memprobe hook the
        # Assembler installs, a per-store array-bytes inventory) at
        # every stage end — the audit tool for the bytes-per-base
        # budget (reference runs at 4-6 B/base,
        # docs/ComputationalMethods.html "High performance computing").
        self.memprof = bool(os.environ.get("SHASTA_TORCH_MEMPROF"))
        self.memprobe = None  # optional () -> str

    def line(self, msg: str) -> None:
        ts = datetime.datetime.now().strftime("%Y-%b-%d %H:%M:%S.%f")
        text = f"{ts} {msg}"
        if self._f:
            self._f.write(text + "\n")
            self._f.flush()
        if self._echo:
            print(text, file=sys.stderr)

    @contextlib.contextmanager
    def stage(self, name: str):
        self.line(f"Begin {name}.")
        if self.memprof:
            hwm_ok = reset_peak_rss()
        t0 = time.monotonic()
        try:
            with span(f"stage:{name}"):
                yield
        finally:
            dt = time.monotonic() - t0
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + dt
            self.line(f"End {name} ({dt:.3f} s).")
            # Return freed arena pages to the OS at every stage
            # boundary (glibc keeps sbrk heap grown by a stage's large
            # transients: createMarkerGraphVertices alone retained
            # +7 GB RSS at ONT-25Mb before this; ~ms on a 10 GB heap).
            malloc_trim()
            if self.memprof:
                peak = f" peak={peak_rss_mb():.0f}MB" if hwm_ok else ""
                inv = f" | {self.memprobe()}" if self.memprobe else ""
                msg = (
                    f"[memprof] after {name}: rss={rss_mb():.0f}MB"
                    f"{peak}{inv}"
                )
                self.line(msg)
                print(msg, file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class Tee:
    """Duplicate stdout to a log file for the duration of a run
    (reference: src/Tee.hpp, engaged at srcMain/main.cpp:334-337 to
    produce stdout.log). Use as a context manager."""

    def __init__(self, path: str):
        self._path = path
        self._f: Optional[TextIO] = None
        self._saved = None

    def __enter__(self):
        self._f = open(self._path, "w")
        self._saved = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._saved
        if self._f:
            self._f.close()
            self._f = None
        return False

    def write(self, s):
        self._saved.write(s)
        if self._f:
            self._f.write(s)
        return len(s)

    def flush(self):
        self._saved.flush()
        if self._f:
            self._f.flush()

