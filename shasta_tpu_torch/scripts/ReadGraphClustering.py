#!/usr/bin/env python
"""Cluster the read graph into connected components and write
ReadGraphClusters.csv (reference: scripts/ReadGraphClustering.py ->
Assembler::readGraphClustering)."""
import os
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.graph.read_graph import connected_components


def main(argv=None) -> int:
    a, _ = open_run(argv)
    comp = connected_components(a.read_graph)
    sizes = np.bincount(comp)
    order = np.argsort(sizes)[::-1]
    out = os.path.join(a.run_dir, "ReadGraphClusters.csv")
    with open(out, "w") as f:
        f.write("OrientedReadId,Cluster\n")
        for orid, c in enumerate(comp.tolist()):
            f.write(f"{orid},{c}\n")
    nz = sizes[sizes > 0]
    print(f"{nz.shape[0]} clusters; largest {sizes[order[0]]} oriented reads.")
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
