#!/usr/bin/env python
"""Verify and write the marker graph's reverse-complement vertex map
(reference: scripts/FindMarkerGraphReverseComplementVertices.py).

In this framework the rc map is computed during vertex creation and
stored with the marker graph; this script audits the involution and
writes it out as a CSV.
"""
import os
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.graph.marker_graph import check_strand_symmetry


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    rc = mg.rc_vertex
    assert np.array_equal(rc[rc], np.arange(mg.vertex_count)), (
        "rc vertex map is not an involution"
    )
    out = os.path.join(a.run_dir, "MarkerGraphReverseComplementVertex.csv")
    with open(out, "w") as f:
        f.write("VertexId,ReverseComplementVertexId\n")
        for v, r in enumerate(rc.tolist()):
            f.write(f"{v},{r}\n")
    print(f"rc map verified for {mg.vertex_count} vertices; wrote {out}")
    print(f"Strand symmetric: {check_strand_symmetry(mg)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
