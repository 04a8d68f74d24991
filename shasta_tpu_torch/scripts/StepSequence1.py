#!/usr/bin/env python
"""Run the marker graph -> assembly step sequence on a stored run
(reference: scripts/StepSequence1.py). Each step gets this driver's
arguments (the run directory and ``--device``)."""
import sys

from _common import load


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    for module in (
        "CreateMarkerGraphVertices",
        "FindMarkerGraphReverseComplementVertices",
        "CreateMarkerGraphEdges",
        "FindMarkerGraphReverseComplementEdges",
        "TransitiveReduction",
        "PruneMarkerGraphStrongSubgraph",
        "SimplifyMarkerGraph",
        "CreateAssemblyGraphEdges",
        "AssembleMarkerGraphVertices",
        "AssembleMarkerGraphEdges",
        "Assemble",
    ):
        print(f"=== {module}")
        rc = load(module).main(argv)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
