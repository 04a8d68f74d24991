"""stage_s.align: seconds per assembly in computeAlignments
(the run summary's stageSeconds, averaged over the window's assemblies)."""

from perfbench.readers import stage_seconds


def read(run):
    return stage_seconds(run, "align")
