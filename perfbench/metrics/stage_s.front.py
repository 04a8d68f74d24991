"""stage_s.front: seconds per assembly in addReads through findAlignmentCandidates
(the run summary's stageSeconds, averaged over the window's assemblies)."""

from perfbench.readers import stage_seconds


def read(run):
    return stage_seconds(run, "front")
