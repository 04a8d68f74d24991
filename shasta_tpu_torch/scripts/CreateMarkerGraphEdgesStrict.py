#!/usr/bin/env python
"""Strict (mode 2) marker graph edge creation
(reference: scripts/CreateMarkerGraphEdgesStrict.py). The function takes
the reads first, as Assembler.create_marker_graph_edges passes them."""
import sys

from _common import open_run
from shasta_tpu_torch.graph.mode2 import create_marker_graph_edges_strict


def main(argv=None) -> int:
    a, _ = open_run(argv)
    cm = a.config.marker_graph
    create_marker_graph_edges_strict(
        a.reads, a.markers, a.marker_graph,
        min_edge_coverage=cm.min_edge_coverage,
        min_edge_coverage_per_strand=cm.min_edge_coverage_per_strand,
    )
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"{a.marker_graph.edge_count} strict edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
