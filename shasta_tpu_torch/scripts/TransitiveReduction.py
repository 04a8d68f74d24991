#!/usr/bin/env python
"""Approximate transitive reduction of the marker graph
(reference: scripts/TransitiveReduction.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import marker_graph as MG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    cm = a.config.marker_graph
    MG.transitive_reduction(
        a.marker_graph,
        low_coverage_threshold=cm.low_coverage_threshold,
        high_coverage_threshold=cm.high_coverage_threshold,
        max_distance=cm.max_distance,
        edge_marker_skip_threshold=cm.edge_marker_skip_threshold,
    )
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    alive = int(a.marker_graph.alive().sum())
    print(f"{alive} edges alive after transitive reduction.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
