#!/usr/bin/env python
"""Rebuild the assembly graph (linear-chain condensation) from the
stored marker graph (reference: scripts/CreateAssemblyGraphEdges.py +
CreateAssemblyGraphVertices.py — a single pass here: this build
creates vertices and edges together)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import assembly_graph as AG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AG.create_assembly_graph(a.marker_graph)
    a.store.save_stage("AssemblyGraph", ag.arrays())
    print(f"Assembly graph: {ag.edge_count} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
