#!/usr/bin/env python
"""Add secondary edges to restore contiguity after strict edge
creation (reference: scripts/CreateMarkerGraphSecondaryEdges.py).

Usage: CreateMarkerGraphSecondaryEdges.py [runDir] [maxSkip]
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.mode2 import create_marker_graph_secondary_edges


def main(argv=None) -> int:
    a, args = open_run(argv)
    max_skip = int(args[1]) if len(args) > 1 else \
        a.config.marker_graph.secondary_edges_max_skip
    n = create_marker_graph_secondary_edges(a.markers, a.marker_graph, max_skip)
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"Added {n} secondary marker graph edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
