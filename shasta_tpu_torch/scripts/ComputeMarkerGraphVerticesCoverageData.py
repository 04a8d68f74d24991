#!/usr/bin/env python
"""Write per-vertex coverage data: total coverage and per-strand
coverage (reference: scripts/ComputeMarkerGraphVerticesCoverageData.py)."""
import os
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    moff = a.markers.offsets
    orid_of = np.searchsorted(moff, np.arange(moff[-1]), side="right") - 1
    out = os.path.join(a.run_dir, "MarkerGraphVerticesCoverageData.csv")
    with open(out, "w") as f:
        f.write("VertexId,Coverage,Strand0Coverage,Strand1Coverage\n")
        for v in range(mg.vertex_count):
            ms = mg.vertex_marker_ids(v)
            strands = orid_of[ms] % 2
            s1 = int(strands.sum())
            f.write(f"{v},{ms.shape[0]},{ms.shape[0] - s1},{s1}\n")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
