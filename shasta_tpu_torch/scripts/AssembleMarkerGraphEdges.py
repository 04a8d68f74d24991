#!/usr/bin/env python
"""Assemble the consensus sequence of all marker graph edges
(reference: scripts/AssembleMarkerGraphEdges.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.consensus.caller import get_consensus_caller
from shasta_tpu_torch.graph import assembly_graph as AG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    spec = a.config.assembly.consensus_caller
    vertex_repeats = AG.assemble_marker_graph_vertices(
        a.reads, a.markers, a.marker_graph
    )
    ec = AG.assemble_marker_graph_edges(
        a.reads, a.markers, a.marker_graph,
        caller=get_consensus_caller(spec),
    )
    a.store.save_stage("EdgeConsensus", ec.arrays())
    n = sum(1 for e in range(a.marker_graph.edge_count) if ec.get(e) is not None)
    print(f"Assembled consensus for {a.marker_graph.edge_count} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
