#!/usr/bin/env python
"""Write marker graph vertex coverage statistics grouped by k-mer id
(reference: scripts/VertexCoverageStatisticsByKmerId.py)."""
import os
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    # The k-mer of a vertex is the k-mer of any of its markers.
    first_marker = mg.vertex_markers[mg.vertex_offsets[:-1]]
    kmer = a.markers.kmer_ids[first_marker]
    coverage = mg.vertex_coverage()
    order = np.argsort(kmer, kind="stable")
    out = os.path.join(a.run_dir, "VertexCoverageStatisticsByKmerId.csv")
    with open(out, "w") as f:
        f.write("KmerId,VertexCount,TotalCoverage,MeanCoverage\n")
        ks = kmer[order]
        cs = coverage[order]
        starts = np.concatenate(([0], np.flatnonzero(np.diff(ks)) + 1, [ks.shape[0]]))
        for i in range(starts.shape[0] - 1):
            lo, hi = starts[i], starts[i + 1]
            tot = int(cs[lo:hi].sum())
            f.write(f"{ks[lo]},{hi - lo},{tot},{tot / (hi - lo):.2f}\n")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
