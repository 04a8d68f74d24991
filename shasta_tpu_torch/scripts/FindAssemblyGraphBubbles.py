#!/usr/bin/env python
"""Find 2-branch bubbles in the stored assembly graph and write
AssemblyGraphBubbles.csv (reference: scripts/FindAssemblyGraphBubbles.py)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph
from shasta_tpu_torch.graph.mode2 import find_bubbles


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    bubbles = find_bubbles(ag, a.marker_graph)
    out = os.path.join(a.run_dir, "AssemblyGraphBubbles.csv")
    with open(out, "w") as f:
        f.write("V0,V1,Branch0,Branch1,Reads0,Reads1\n")
        for b in bubbles:
            f.write(
                f"{b.v0},{b.v1},{b.branch_edges[0]},{b.branch_edges[1]},"
                f"{b.reads0.shape[0]},{b.reads1.shape[0]}\n"
            )
    print(f"{len(bubbles)} bubbles. Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
