"""Arithmetic that several metric readers (``metrics/<name>.py``) share."""

# The program's stages (the run summary's ``stageSeconds``) by layer;
# every stage after computeAlignments is ``graphs``.
STAGES = {
    "front": ("addReads", "selectKmers", "findMarkers", "flagPalindromicReads",
              "findAlignmentCandidatesLowHash"),
    "align": ("computeAlignments",),
}


def stage_seconds(run, layer):
    """Mean seconds per assembly of the window in ``layer``'s stages."""
    if not run.stage_seconds:
        return None
    named = {k for ks in STAGES.values() for k in ks}
    pick = (lambda k: k not in named) if layer == "graphs" else (lambda k: k in STAGES[layer])
    return sum(sum(v for k, v in s.items() if pick(k)) for s in run.stage_seconds) \
        / len(run.stage_seconds)


def idle_pct(run, kind):
    """The share of a ``kind`` window in which no operation ran on the
    device (torch.profiler's trace), in %."""
    if run.trace is None or run.kind != kind:
        return None
    return 100.0 * (1.0 - run.trace.busy_seconds() / run.window_s)
