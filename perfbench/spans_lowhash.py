"""Arithmetic that the readers of LowHash's spans and counter share: the
``stage:lowhash.*`` ranges that ``shasta_tpu_torch`` opens in
``ops/lowhash.py:find_candidates_lowhash`` (``utils/perf.py:span``), read
from the traced window of an assemble cell, and that module's ``COUNTS``.
A program without them gives None."""

import sys


def seconds_per_assembly(run, name):
    """The summed duration of the window's spans ``name`` over its
    assemblies, in s, or None where there is none."""
    if run.trace is None or run.kind != "assemble" or not run.items:
        return None
    got = [e - s for s, e, n in run.trace.spans if n == name]
    if not got:
        return None
    return sum(got) * 1e-9 / run.items


def pair_keys():
    """The pair keys that the program's last LowHash call counted
    (``ops/lowhash.py:COUNTS``), or None."""
    mod = sys.modules.get("shasta_tpu_torch.ops.lowhash")
    counts = getattr(mod, "COUNTS", None)
    if not counts:
        return None
    return counts.get("pair_keys") or None
