#!/usr/bin/env python
"""Reverse-direction transitive reduction of the marker graph
(reference: scripts/ReverseTransitiveReduction.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import marker_graph as MG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    cm = a.config.marker_graph
    n = MG.reverse_transitive_reduction(
        a.marker_graph,
        low_coverage_threshold=cm.low_coverage_threshold,
        high_coverage_threshold=cm.high_coverage_threshold,
        max_distance=cm.max_distance,
    )
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"Reverse transitive reduction flagged {n} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
