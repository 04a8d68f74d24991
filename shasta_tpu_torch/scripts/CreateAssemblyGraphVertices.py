#!/usr/bin/env python
"""Create the assembly graph (vertices are created together with the
edge condensation in this framework)
(reference: scripts/CreateAssemblyGraphVertices.py)."""
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import create_assembly_graph


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = create_assembly_graph(a.marker_graph)
    a.store.save_stage("AssemblyGraph", ag.arrays())
    n_vertices = np.unique(np.concatenate([ag.source_v, ag.target_v])).shape[0]
    print(f"Assembly graph: {n_vertices} vertices, {ag.edge_count} edges.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
