#!/usr/bin/env python
"""Cluster the oriented reads of a marker graph edge based on their
fill-sequence similarity
(reference: scripts/ClusterMarkerGraphEdgeOrientedReads.py).

Usage: ClusterMarkerGraphEdgeOrientedReads.py <runDir> <edgeId> [errorRateThreshold]
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.mode2 import cluster_edge_oriented_reads


def main(argv=None) -> int:
    a, args = open_run(argv)
    edge_id = int(args[1])
    threshold = float(args[2]) if len(args) > 2 else 0.2
    orids, _o0, _o1 = a.marker_graph.edge_intervals(edge_id)
    clusters = cluster_edge_oriented_reads(
        a.reads, a.markers, a.marker_graph, edge_id, threshold
    )
    print(f"Edge {edge_id}: {orids.shape[0]} oriented reads, "
          f"{len(clusters)} clusters at error rate threshold {threshold}:")
    for c in clusters:
        print("  " + " ".join(str(int(orids[i])) for i in c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
