"""The traced run: a ``torch.profiler`` trace of the window, the
harness's spans, and what the per-layer metrics read from them.

Spans are ``torch.profiler.record_function`` ranges, so they sit in the
same trace, on the same clock, as the device's operations: one per unit
of the window's work (``assembly`` or ``pass``), and one per stage of
the program (``stage:<name>``), opened around each ``PerformanceLog``
stage by wrapping that context manager from outside while the trace
runs.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


# The harness's spans around one unit of a window's work.
SPAN_NAMES = ("assembly", "pass")
# Device operations are named in the breakdown by at most this many characters.
NAME_CHARS = 160


def span(name: str):
    """A span around the harness's call of one unit of work (a no-op
    unless a profiler is recording)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage_spans():
    """While active, every ``PerformanceLog.stage(name)`` of the program
    also opens the span ``stage:<name>``."""
    from shasta_tpu_torch.utils.perf import PerformanceLog

    original = PerformanceLog.stage

    @contextlib.contextmanager
    def stage(self, name):
        with torch.profiler.record_function(f"stage:{name}"), original(self, name):
            yield

    PerformanceLog.stage = stage
    try:
        yield
    finally:
        PerformanceLog.stage = original


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_annotation(ev) -> bool:
    """A ``record_function`` range, which the trace also draws on the
    device's timeline (``gpu_user_annotation``): no device work."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    name = ev.name()
    return name in SPAN_NAMES or name.startswith("stage:")


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


@dataclass
class Trace:
    """Device operations and host spans of the window, in ns."""

    device: List[Tuple[int, int, str]] = field(default_factory=list)
    spans: List[Tuple[int, int, str]] = field(default_factory=list)
    host_ops: List[Tuple[int, int, str]] = field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        t = cls()
        for ev in prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if _is_annotation(ev):
                if ev.device_type() != torch.autograd.DeviceType.CUDA:
                    t.spans.append((start, end, ev.name()))
            elif ev.device_type() == torch.autograd.DeviceType.CUDA:
                t.device.append((start, end, ev.name()))
            else:
                t.host_ops.append((start, end, ev.name()))
        t.device.sort()
        t.spans.sort()
        t.host_ops.sort()
        return t

    def kernel_seconds(self) -> float:
        """The summed time of every kernel on the device: its operations
        less the copies and fills (``Memcpy ...``, ``Memset ...``)."""
        return sum(e - s for s, e, n in self.device
                   if not n.startswith(("Memcpy", "Memset"))) * 1e-9

    def merged(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_seconds(self) -> float:
        """The time in which some operation ran on the device."""
        return sum(e - s for s, e in self.merged()) * 1e-9

    def bounds(self) -> Optional[Tuple[int, int]]:
        units = [(s, e) for s, e, n in self.spans if not n.startswith("stage:")]
        if not units:
            return None
        return min(s for s, _ in units), max(e for _, e in units)

    @staticmethod
    def _innermost(events, t: int) -> Optional[str]:
        best = None
        for s, e, n in events:
            if s > t:
                break
            if t <= e and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else None

    def label(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost span open then,
        and the innermost torch operation, or ``host`` when none was."""
        where = self._innermost(self.spans, t) or "harness"
        return f"{where} > {self._innermost(self.host_ops, t) or 'host'}"

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0) + (e - s)
        top_ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], v * 1e-9] for n, v in top_ops]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest gaps between device operations inside the
        window, each named by the span the host was in at its middle."""
        lim = self.bounds()
        if lim is None:
            return []
        edges = [lim[0]]
        for s, e in self.merged():
            edges += [s, e]
        edges.append(lim[1])
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lim[0]), min(b, lim[1])
            if b > a:
                gaps.append((b - a, a))
        gaps.sort(reverse=True)
        return [[self.label(a + g // 2), g * 1e-9] for g, a in gaps[:top]]
