#!/usr/bin/env python
"""Analyze the pairwise relations of a set of mode-3 segments
(reference: scripts/AnalyzeMode3Subgraph.py).

Usage: AnalyzeMode3Subgraph.py <runDir> <segmentId> [segmentId ...]
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.mode3 import Mode3Graph
from shasta_tpu_torch.graph.mode3_path import Mode3Connectivity


def main(argv=None) -> int:
    a, args = open_run(argv)
    segment_ids = [int(x) for x in args[1:]]
    if not segment_ids:
        segment_ids = [int(t) for t in input("Enter segment ids on one line: ").split()]
    m3 = Mode3Graph.from_arrays(a.store.load_stage("Mode3"))
    conn = Mode3Connectivity(m3, a.marker_graph, a.markers)
    print("SegmentA,SegmentB,CommonReads,Jaccard,RawJaccard,MaxUnexplained")
    for i, s0 in enumerate(segment_ids):
        for s1 in segment_ids[i + 1:]:
            info = conn.analyze_segment_pair(s0, s1)
            print(f"{s0},{s1},{info.common_count},{info.jaccard():.3f},"
                  f"{conn.raw_jaccard(info):.3f},"
                  f"{info.maximum_unexplained_fraction():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
