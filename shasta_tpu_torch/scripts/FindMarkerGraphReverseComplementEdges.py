#!/usr/bin/env python
"""Verify and write the marker graph's reverse-complement edge map
(reference: scripts/FindMarkerGraphReverseComplementEdges.py)."""
import os
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    re = mg.rc_edge
    if re is None or re.shape[0] == 0:
        print("No edges (create marker graph edges first).")
        return 1
    assert np.array_equal(re[re], np.arange(mg.edge_count)), (
        "rc edge map is not an involution"
    )
    assert np.array_equal(mg.source[re], mg.rc_vertex[mg.target]), (
        "rc edge endpoints are not strand symmetric"
    )
    out = os.path.join(a.run_dir, "MarkerGraphReverseComplementEdge.csv")
    with open(out, "w") as f:
        f.write("EdgeId,ReverseComplementEdgeId\n")
        for e, r in enumerate(re.tolist()):
            f.write(f"{e},{r}\n")
    print(f"rc edge map verified for {mg.edge_count} edges; wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
