#!/usr/bin/env python
"""Write a Bandage-compatible CSV coloring 'key' segments — long
segments likely to appear once in the genome
(reference: scripts/ColorGfaKeySegments.py -> colorGfaKeySegments)."""
import os
import sys

from _common import open_run
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph


def main(argv=None) -> int:
    a, args = open_run(argv)
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    min_markers = int(args[2]) if len(args) > 2 else 100
    out = os.path.join(a.run_dir, "GfaKeySegmentsColor.csv")
    n_key = 0
    with open(out, "w") as f:
        f.write("Segment,Color\n")
        for e in range(ag.edge_count):
            if not ag.is_assembled_edge(e):
                continue
            is_key = ag.chain(e).shape[0] >= min_markers
            f.write(f"{e},{'Red' if is_key else 'Grey'}\n")
            n_key += is_key
    print(f"{n_key} key segments (>= {min_markers} marker graph edges). Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
