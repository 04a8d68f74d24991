"""align_fetches_per_1k: the program's blocking device-to-host fetches
(its ``stage:align.fetch`` spans) per 1,000 candidates aligned in the window."""

from perfbench.spans import align_spans


def read(run):
    got = align_spans(run, "stage:align.fetch")
    if got is None or not run.candidates:
        return None
    return len(got) * 1000.0 / run.candidates
