#!/usr/bin/env python
"""Re-run marker graph vertex creation
(reference: scripts/CreateMarkerGraphVertices.py)."""
import sys
from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.create_marker_graph_vertices()
    print(f"Marker graph: {a.marker_graph.vertex_count} vertices.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
