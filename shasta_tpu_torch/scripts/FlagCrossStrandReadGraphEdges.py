#!/usr/bin/env python
"""Flag cross-strand read graph edges (strand separation method 1)
(reference: scripts/FlagCrossStrandReadGraphEdges.py).

Usage: FlagCrossStrandReadGraphEdges.py [runDir] [maxDistance]
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.read_graph import flag_cross_strand_edges1


def main(argv=None) -> int:
    a, args = open_run(argv)
    max_distance = int(args[1]) if len(args) > 1 else \
        a.config.read_graph.cross_strand_max_distance
    n = flag_cross_strand_edges1(
        a.read_graph, a.alignments, a.reads.read_count, max_distance
    )
    a.store.save_stage("ReadGraph", a.read_graph.arrays())
    print(f"Flagged {n} cross-strand read graph edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
