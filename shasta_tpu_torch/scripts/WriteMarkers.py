#!/usr/bin/env python
"""Dump one oriented read's markers as CSV
(reference: scripts/WriteMarkers.py).

Usage: WriteMarkers.py <runDir> <readId> <strand>
"""
import sys

from _common import open_run


def main(argv=None) -> int:
    a, args = open_run(argv)
    rid, strand = int(args[1]), int(args[2])
    orid = 2 * rid + strand
    lo, hi = a.markers.offsets[orid], a.markers.offsets[orid + 1]
    print("Ordinal,KmerId,Position")
    for t in range(hi - lo):
        print(f"{t},{a.markers.kmer_ids[lo + t]},{a.markers.positions[lo + t]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
