#!/usr/bin/env python
"""Audit marker graph vertexTable/vertices consistency on a stored run
(reference: Assembler::checkMarkerGraphVertices, src/Assembler.hpp:1275,
scripts/CheckMarkerGraphVertices.py-style invariant driver)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph.marker_graph import check_marker_graph_vertices


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ok = check_marker_graph_vertices(a.marker_graph)
    print("Marker graph vertices are" + ("" if ok else " NOT") + " consistent.")
    return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
