#!/usr/bin/env python
"""Build the compressed (bubble-chain condensed) assembly graph and
write CompressedAssemblyGraph.csv
(reference: scripts/CreateCompressedAssemblyGraph.py)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.analysis import compress_assembly_graph
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    cg = compress_assembly_graph(ag)
    out = os.path.join(a.run_dir, "CompressedAssemblyGraph.csv")
    with open(out, "w") as f:
        f.write("CompressedEdgeId,SourceVertex,TargetVertex,MemberSegments\n")
        for e in range(cg.edge_count):
            members = " ".join(str(m) for m in cg.members_of(e).tolist())
            f.write(f"{e},{cg.source_v[e]},{cg.target_v[e]},{members}\n")
    print(f"Compressed assembly graph: {cg.edge_count} edges "
          f"(from {ag.edge_count} assembly graph edges). Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
