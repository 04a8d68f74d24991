#!/usr/bin/env python
"""Dump read graph edges as CSV (reference: scripts/WriteReadGraphEdges.py)."""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    g = a.read_graph
    print("EdgeId,OrientedReadId0,OrientedReadId1,AlignmentId,CrossesStrands,Inconsistent")
    for e in range(g.edge_count):
        print(f"{e},{g.orid0[e]},{g.orid1[e]},{g.alignment_id[e]},"
              f"{int(g.crosses_strands[e])},{int(g.inconsistent[e])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
