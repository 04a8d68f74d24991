#!/usr/bin/env python
"""Per-edge neighborhood statistics CSV
(reference: scripts/AnalyzeReadGraph.py, Assembler::analyzeReadGraph).

Writes AnalyzeReadGraph.csv into the run directory: for each read
graph edge, the neighbor counts of its two vertices, the exclusive
neighbor counts, and the common neighbor count.
"""
import os
import sys

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    g = a.read_graph
    out = os.path.join(a.run_dir, "AnalyzeReadGraph.csv")
    with open(out, "w") as f:
        f.write(
            "EdgeId,OrientedReadId0,OrientedReadId1,"
            "Neighbors0,Neighbors1,Exclusive0,Exclusive1,Common\n"
        )
        for e in range(g.edge_count):
            v0, v1 = int(g.orid0[e]), int(g.orid1[e])
            _, n0 = g.neighbors(v0)
            _, n1 = g.neighbors(v1)
            s0 = set(int(x) for x in n0) - {v1}
            s1 = set(int(x) for x in n1) - {v0}
            common = len(s0 & s1)
            f.write(
                f"{e},{v0},{v1},{len(n0)},{len(n1)},"
                f"{len(s0 - s1)},{len(s1 - s0)},{common}\n"
            )
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
