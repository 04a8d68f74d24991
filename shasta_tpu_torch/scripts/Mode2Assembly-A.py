#!/usr/bin/env python
"""Run the first portion of mode-2 assembly: read graph creation, the
strict marker graph (+ secondary edges), starting from stored
alignments (reference: scripts/Mode2Assembly-A.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.config.assembly.mode = 2
    a.create_read_graph()
    a.create_marker_graph_vertices()
    a.create_marker_graph_edges()
    print(
        f"Mode-2 marker graph: {a.marker_graph.vertex_count} vertices, "
        f"{a.marker_graph.edge_count} edges."
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
