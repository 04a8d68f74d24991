#!/usr/bin/env python
"""Write the assembly graph structure as CSV (segments with their
marker-graph chains) (reference: scripts/WriteAssemblyGraph.py).

Usage: WriteAssemblyGraph.py <runDir> [output.csv]
"""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph


def main(argv=None) -> int:
    a, args = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    out = args[1] if len(args) > 1 else os.path.join(a.run_dir, "AssemblyGraph.csv")
    with open(out, "w") as f:
        f.write("Segment,Source,Target,MarkerGraphEdgeCount,IsAssembled\n")
        for e in range(ag.edge_count):
            chain = ag.chain(e)
            f.write(f"{e},{ag.source_v[e]},{ag.target_v[e]},{chain.shape[0]},"
                    f"{int(ag.is_assembled_edge(e))}\n")
    print(f"Wrote {ag.edge_count} assembly graph edges to {out}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
