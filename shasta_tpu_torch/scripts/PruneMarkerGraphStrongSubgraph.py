#!/usr/bin/env python
"""Prune marker graph leaves
(reference: scripts/PruneMarkerGraphStrongSubgraph.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph import marker_graph as MG


def main(argv=None) -> int:
    a, _ = open_run(argv)
    MG.prune(a.marker_graph, iteration_count=a.config.marker_graph.prune_iteration_count)
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"Pruned: {int(a.marker_graph.pruned.sum())} edges flagged.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
