"""Arithmetic that the readers of the program's own spans share: the
``stage:align.*`` ranges that ``shasta_tpu_torch`` opens in its align
driver (``utils/perf.py:span``), read from the traced window of an align
cell. A program without them gives None."""


def align_spans(run, name):
    """(start, end) in ns of every span ``name`` in an align cell's
    traced window, or None where there is none."""
    if run.trace is None or run.kind != "align":
        return None
    got = [(s, e) for s, e, n in run.trace.spans if n == name]
    return got or None


def seconds_per_pass(run, name):
    """The summed duration of the window's spans ``name`` over its
    passes, in s."""
    got = align_spans(run, name)
    if got is None or not run.items:
        return None
    return sum(e - s for s, e in got) * 1e-9 / run.items
