#!/usr/bin/env python
"""Split secondary marker graph edges with inconsistent fill
sequences into per-cluster edges
(reference: scripts/SplitMarkerGraphSecondaryEdges.py).

Usage: SplitMarkerGraphSecondaryEdges.py [runDir] [errorRateThreshold] [minCoverage]
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.mode2 import split_marker_graph_secondary_edges


def main(argv=None) -> int:
    a, args = open_run(argv)
    threshold = float(args[1]) if len(args) > 1 else 0.1
    min_cov = int(args[2]) if len(args) > 2 else 2
    n_split, n_created = split_marker_graph_secondary_edges(
        a.reads, a.markers, a.marker_graph, threshold, min_cov
    )
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"Split {n_split} secondary edges into {n_created} new edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
