#!/usr/bin/env python
"""Write the oriented reads contributing to each assembly graph
segment (reference: scripts/WriteOrientedReadsBySegment.py)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.detangle import _edge_oriented_reads


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    out = os.path.join(a.run_dir, "OrientedReadsBySegment.csv")
    with open(out, "w") as f:
        f.write("Segment,OrientedReadId,ReadId,Strand\n")
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            for orid in _edge_oriented_reads(ag, a.marker_graph, e).tolist():
                f.write(f"{e},{orid},{orid // 2},{orid % 2}\n")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
