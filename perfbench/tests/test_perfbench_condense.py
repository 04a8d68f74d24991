"""The reader of the program's ``stage:graphs.condense`` span
(``metrics/graphs_condense_s.py``): exact on a trace built by hand, None
where it has nothing to read."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.trace import Trace

MS = 1_000_000


def hand_trace() -> Trace:
    """Two assemblies of 1 s; in each, 11 condensations of 2 ms inside
    the stages that open them."""
    t = Trace()
    for a in range(2):
        base = a * 1000 * MS
        t.spans.append((base, base + 1000 * MS, "assembly"))
        t.spans.append((base + 100 * MS, base + 600 * MS, "stage:simplifyMarkerGraph"))
        for k in range(11):
            lo = base + (100 + 40 * k + 1) * MS
            t.spans.append((lo, lo + 2 * MS, "stage:graphs.condense"))
    t.spans.sort()
    return t


def test_reader_exact_on_a_hand_trace():
    run = SimpleNamespace(trace=hand_trace(), kind="assemble", items=2)
    assert harness.reader("graphs_condense_s")(run) == pytest.approx(0.022, rel=1e-12)


@pytest.mark.parametrize("case", ["align", "untraced", "no_spans"])
def test_reader_none_without_spans(case):
    """On an align run, untraced, or on a program that opens no
    ``stage:graphs.condense`` span (one from before the span), None."""
    run = {
        "align": SimpleNamespace(trace=hand_trace(), kind="align", items=2),
        "untraced": SimpleNamespace(trace=None, kind="assemble", items=2),
        "no_spans": SimpleNamespace(trace=Trace(spans=[(0, 10, "assembly")]), kind="assemble",
                                    items=2),
    }[case]
    assert harness.reader("graphs_condense_s")(run) is None
