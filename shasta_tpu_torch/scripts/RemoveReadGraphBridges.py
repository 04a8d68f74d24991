#!/usr/bin/env python
"""Remove read graph bridges (reference: scripts/RemoveReadGraphBridges.py).

Usage: RemoveReadGraphBridges.py <runDir> [maxDistance]
"""
import sys

from _common import open_run
from shasta_tpu_torch.graph.read_graph import remove_read_graph_bridges


def main(argv=None) -> int:
    a, args = open_run(argv)
    d = int(args[1]) if len(args) > 1 else 2
    a.read_graph, keep, removed = remove_read_graph_bridges(
        a.read_graph, a.alignments, a.reads.read_count, d
    )
    a.store.save_stage("ReadGraph", a.read_graph.arrays())
    print(f"Removed {removed} bridge alignments; "
          f"{int(keep.sum())} of {a.alignments.count} alignments remain.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
