#!/usr/bin/env python
"""Detangle with method-2 semantics: dominant-diagonal tangle matrix
with off-diagonal tolerances, including colliding tangle pairs
(reference: scripts/Detangle2.py -> AssemblyPathGraph2)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import assembly_graph as AG
from shasta_tpu_torch.graph.detangle import detangle_assembly_graph


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AG.AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    before = ag.edge_count
    ag = detangle_assembly_graph(ag, a.marker_graph)
    a.store.save_stage("AssemblyGraph", ag.arrays())
    print(f"Detangled (method 2): {before} -> {ag.edge_count} assembly "
          "graph edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
