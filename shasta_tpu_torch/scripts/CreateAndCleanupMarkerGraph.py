#!/usr/bin/env python
"""Create marker graph vertices, clean up duplicate markers, and
create edges, in one step
(reference: scripts/CreateAndCleanupMarkerGraph.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.config.marker_graph.allow_duplicate_markers = True
    a.config.marker_graph.cleanup_duplicate_markers = True
    a.create_marker_graph_vertices()
    a.create_marker_graph_edges()
    print(
        f"Marker graph: {a.marker_graph.vertex_count} vertices, "
        f"{a.marker_graph.edge_count} edges."
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
