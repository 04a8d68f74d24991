#!/usr/bin/env python
"""Write assembly details for a single assembly graph segment (edge)
to a CSV (reference: scripts/AssembleSegment.py).

Usage: AssembleSegment.py <runDir> <edgeId>
"""
import os
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.data import bases as B
from shasta_tpu_torch.graph.assembly_graph import AssemblyGraph


def main(argv=None) -> int:
    a, args = open_run(argv)
    edge_id = int(args[1])
    ag = AssemblyGraph.from_arrays(a.store.load_stage("AssemblyGraph"))
    chain = ag.chain(edge_id)
    seq = (
        ag.raw_sequence(edge_id)
        if ag.seg_raw_offsets is not None
        else np.zeros(0, np.uint8)
    )
    out = os.path.join(a.run_dir, f"AssembledSegment-{edge_id}.csv")
    with open(out, "w") as f:
        f.write("Position,MarkerGraphEdgeId\n")
        for pos, me in enumerate(chain.tolist()):
            f.write(f"{pos},{me}\n")
    print(f"Segment {edge_id}: {chain.shape[0]} marker graph edges, "
          f"{seq.shape[0]} raw bases.")
    print(f">{edge_id}")
    print(B.decode_to_str(seq))
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
