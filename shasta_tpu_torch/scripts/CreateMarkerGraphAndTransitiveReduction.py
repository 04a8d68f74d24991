#!/usr/bin/env python
"""Create marker graph vertices and edges, then run transitive
reduction, in one step
(reference: scripts/CreateMarkerGraphAndTransitiveReduction.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.create_marker_graph_vertices()
    a.create_marker_graph_edges()
    alive = int(a.marker_graph.alive().sum())
    print(
        f"Marker graph: {a.marker_graph.vertex_count} vertices, "
        f"{alive} edges alive after transitive reduction."
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
