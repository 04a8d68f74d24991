#!/usr/bin/env python
"""Write marker graph vertices containing more than one marker of the
same oriented read (reference: scripts/WriteBadMarkerGraphVertices.py)."""
import os
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    moff = a.markers.offsets
    # Oriented read of each marker id.
    orid_of = np.searchsorted(moff, np.arange(moff[-1]), side="right") - 1
    out = os.path.join(a.run_dir, "BadMarkerGraphVertices.csv")
    n_bad = 0
    with open(out, "w") as f:
        f.write("VertexId,Coverage,DuplicateOrientedReadIds\n")
        for v in range(mg.vertex_count):
            ms = mg.vertex_marker_ids(v)
            orids = orid_of[ms]
            uniq, counts = np.unique(orids, return_counts=True)
            dup = uniq[counts > 1]
            if dup.shape[0]:
                f.write(f"{v},{ms.shape[0]},"
                        f"{' '.join(str(x) for x in dup.tolist())}\n")
                n_bad += 1
    print(f"{n_bad} vertices with duplicate oriented reads. Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
