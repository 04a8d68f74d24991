#!/usr/bin/env python
"""Clean up marker graph vertices with duplicate markers
(reference: scripts/CleanupDuplicateMarkers.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import marker_graph as MG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    u, v = MG.gather_unite_pairs(
        a.markers, a.read_graph, a.alignments,
        a.reads.is_chimeric if a.reads is not None else None,
    )
    cm = a.config.marker_graph
    a.marker_graph = MG.cleanup_duplicate_markers(
        a.markers, a.marker_graph, u, v,
        min_coverage=max(cm.min_coverage, 1),
        min_coverage_per_strand=cm.min_coverage_per_strand,
        pattern1_threshold=cm.duplicate_markers_pattern1_threshold,
    )
    stats = getattr(a.marker_graph, "cleanup_stats", {})
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"Cleanup stats: {stats}; now {a.marker_graph.vertex_count} vertices.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
