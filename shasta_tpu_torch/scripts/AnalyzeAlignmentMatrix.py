#!/usr/bin/env python
"""Analyze the alignment matrix of two oriented reads: matching-marker
dots, their diagonal histogram, and the implied band
(reference: scripts/AnalyzeAlignmentMatrix.py).

Usage: AnalyzeAlignmentMatrix.py <runDir> <readId0> <strand0> <readId1> <strand1>
"""
import sys

import numpy as np

from _common import open_run
from shasta_tpu_torch.ops.align_other import dots_between


def main(argv=None) -> int:
    a, args = open_run(argv)
    r0, s0, r1, s1 = (int(x) for x in args[1:5])
    k0, _ = a.markers.get(2 * r0 + s0)
    k1, _ = a.markers.get(2 * r1 + s1)
    x, y = dots_between(k0, k1)
    print(f"Marker counts: {k0.shape[0]} x {k1.shape[0]}")
    print(f"Matrix dots (matching marker pairs): {x.shape[0]}")
    if x.shape[0]:
        d = x.astype(np.int64) - y.astype(np.int64)
        hist, edges = np.histogram(d, bins=min(40, max(1, d.max() - d.min() + 1)))
        print("Diagonal (ordinal0 - ordinal1) histogram:")
        for c, lo, hi in zip(hist.tolist(), edges[:-1], edges[1:]):
            if c:
                print(f"  [{int(lo)}, {int(hi)}): {c}")
        best = np.argmax(hist)
        print(f"Dominant diagonal band: [{int(edges[best])}, {int(edges[best+1])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
