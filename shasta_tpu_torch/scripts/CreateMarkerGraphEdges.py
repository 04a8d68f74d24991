#!/usr/bin/env python
"""Re-run marker graph edge creation + cleanup passes
(reference: scripts/CreateMarkerGraphEdges.py)."""
import sys
from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.create_marker_graph_edges()
    print(f"Marker graph: {a.marker_graph.edge_count} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
