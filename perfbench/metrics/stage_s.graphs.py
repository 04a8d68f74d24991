"""stage_s.graphs: seconds per assembly in every stage after
computeAlignments, the read graph to the output (the run summary's
stageSeconds, averaged over the window's assemblies)."""

from perfbench.readers import stage_seconds


def read(run):
    return stage_seconds(run, "graphs")
