#!/usr/bin/env python
"""Audit the marker graph's strand symmetry invariant
(reference: scripts/CheckMarkerGraphIsStrandSymmetric.py)."""
import sys

from _common import open_run
from shasta_tpu_torch.graph.marker_graph import check_strand_symmetry


def main(argv=None) -> int:
    a, _ = open_run(argv)
    ok = check_strand_symmetry(a.marker_graph)
    print("Marker graph is strand symmetric." if ok else "STRAND SYMMETRY VIOLATED.")
    return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
