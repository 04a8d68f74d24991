#!/usr/bin/env python
"""Vertex and edge coverage histograms
(reference: scripts/ComputeMarkerGraphCoverageHistogram.py)."""
import sys

import numpy as np

from _common import open_run


def main(argv=None) -> int:
    a, _ = open_run(argv)
    mg = a.marker_graph
    vh = np.bincount(mg.vertex_coverage())
    print("VertexCoverage,Frequency")
    for c, n in enumerate(vh):
        if n:
            print(f"{c},{n}")
    if mg.coverage is not None:
        eh = np.bincount(mg.coverage)
        print("EdgeCoverage,Frequency")
        for c, n in enumerate(eh):
            if n:
                print(f"{c},{n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
