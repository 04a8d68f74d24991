#!/usr/bin/env python
"""Detangle the stored assembly graph using oriented-read paths across
tangles, method-1 semantics: the tangle matrix must be an exact
permutation by read support (reference: scripts/Detangle.py ->
AssemblyPathGraph)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import assembly_graph as AG
from shasta_tpu_torch.graph.detangle import detangle_assembly_graph


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AG.AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    before = ag.edge_count
    ag = detangle_assembly_graph(ag, a.marker_graph, method=1)
    a.store.save_stage("AssemblyGraph", ag.arrays())
    print(f"Detangled: {before} -> {ag.edge_count} assembly graph edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
