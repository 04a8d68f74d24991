#!/usr/bin/env python
"""Read graph creation method 2 (adaptive criteria)
(reference: scripts/CreateReadGraph2.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import read_graph as RG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    a.read_graph, _, criteria = RG.create_read_graph2(
        a.alignments,
        a.reads.read_count,
        max_alignment_count=a.config.read_graph.max_alignment_count,
    )
    a.store.save_stage("ReadGraph", a.read_graph.arrays())
    print(f"{a.read_graph.edge_count} edges; adaptive criteria: {criteria}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
