#!/usr/bin/env python
"""Re-run vertex repeat-count consensus on a stored run
(reference: scripts/AssembleMarkerGraphVertices.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import assembly_graph as AG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    caller = "Median" if a.config.assembly.consensus_caller == "Median" else "Modal"
    vertex_repeats = AG.assemble_marker_graph_vertices(
        a.reads, a.markers, a.marker_graph, caller=caller
    )
    a.store.save_stage("VertexRepeats", {"repeats": vertex_repeats})
    print(f"Assembled repeat counts for "
          f"{a.marker_graph.vertex_count} marker graph vertices.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
