#!/usr/bin/env python
"""Bubble/superbubble removal (reference: scripts/SimplifyMarkerGraph.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph.simplify import simplify_marker_graph


def main(argv=None) -> int:
    a, _ = open_run(argv)
    stats = simplify_marker_graph(
        a.marker_graph,
        [int(x) for x in a.config.marker_graph.simplify_max_length.split(",")],
    )
    a.store.save_stage("MarkerGraph", a.marker_graph.arrays())
    print(f"Simplified marker graph: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
