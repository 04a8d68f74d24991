"""The readers of the program's own spans (``perfbench/spans.py``,
``metrics/align_step_s.*.py``, ``align_fetch_s.py``,
``align_fetches_per_1k.py``): exact values on a trace built by hand,
None where they have nothing to read, and a traced run of ``tiny.align``."""

import json
import math
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.trace import Trace
from perfbench.tests import tiny

STEPS = ("prep", "phase1", "phase2", "collect", "store")
READERS = [f"align_step_s.{s}" for s in STEPS] + ["align_fetch_s", "align_fetches_per_1k"]

# Two passes of 1 s each, in ns; every step span of pass p starts at
# p * 1e9 + 100 * (its index + 1) ms and lasts (index + 1) * 10 ms; three
# fetches of 2 ms in pass 0's phase 2, one of 4 ms in pass 1's collect.
MS = 1_000_000


def hand_trace() -> Trace:
    t = Trace()
    for p in range(2):
        base = p * 1000 * MS
        t.spans.append((base, base + 1000 * MS, "pass"))
        t.spans.append((base + 50 * MS, base + 900 * MS, "stage:computeAlignments"))
        for i, s in enumerate(STEPS):
            lo = base + 100 * (i + 1) * MS
            t.spans.append((lo, lo + (i + 1) * 10 * MS, f"stage:align.{s}"))
    for k in range(3):
        lo = 300 * MS + k * 5 * MS
        t.spans.append((lo, lo + 2 * MS, "stage:align.fetch"))
    t.spans.append((1000 * MS + 400 * MS, 1000 * MS + 404 * MS, "stage:align.fetch"))
    t.spans.sort()
    return t


def run_of(trace, kind="align", items=2, candidates=4000):
    return SimpleNamespace(trace=trace, kind=kind, items=items, candidates=candidates)


EXPECTED = {f"align_step_s.{s}": (i + 1) * 0.010 for i, s in enumerate(STEPS)}
EXPECTED["align_fetch_s"] = (3 * 0.002 + 0.004) / 2
EXPECTED["align_fetches_per_1k"] = 4 * 1000.0 / 4000


@pytest.mark.parametrize("name", READERS)
def test_reader_exact_on_a_hand_trace(name):
    got = harness.reader(name)(run_of(hand_trace()))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["untraced", "assemble", "no_spans"])
def test_reader_none_without_spans(name, case):
    """Untraced, on the assemble kind, or on a program that opens no
    ``align.*`` span (the parent's), every reader gives None."""
    run = {
        "untraced": run_of(None),
        "assemble": run_of(hand_trace(), kind="assemble"),
        "no_spans": run_of(Trace(spans=[(0, 10, "pass"), (1, 9, "stage:computeAlignments")])),
    }[case]
    assert harness.reader(name)(run) is None


def test_traced_tiny_align_prints_every_span_metric(tiny_root, capsys):
    assert tiny.run(tiny_root, "tiny.align", trace=1) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    for name in READERS:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
    assert res["metrics"]["align_fetches_per_1k"]["value"] > 0
